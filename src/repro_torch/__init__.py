"""repro_torch: cuConv on one NVIDIA H100 (PyTorch + hand-written CUDA).

The PyTorch port of the ``repro`` package.  Public functions keep the
reference's layouts (NHWC activations, HWIO filters, name-keyed params)
so the two packages compute the same thing on the same inputs.  The
nine kernels are CUDA C++ for ``sm_90a`` (``repro_torch/csrc``), built
at first use and bound with ``ctypes``; on a CPU tensor each kernel wrapper runs its
plain PyTorch version instead.  Int8 inference lives in
``repro_torch.quant``; the LM substrate in ``repro_torch.models.lm`` and
``repro_torch.serve.engine``.
"""
__version__ = "0.1.0"
from repro_torch.core.cuconv import conv2d  # noqa: F401
from repro_torch.core.convspec import ConvPlan, ConvSpec, plan  # noqa: F401
from repro_torch.core.executors import (  # noqa: F401
    Executor, LaunchConfig, register, unregister)
from repro_torch.core.graph import (  # noqa: F401
    AddOp, ConcatOp, ConvGraph, ConvOp, DenseOp, GapOp, Graph, GraphBuilder,
    GraphPlan, PoolOp, PrecisionPolicy, plan_graph)
from repro_torch.models.cnn import (  # noqa: F401
    GraphModel, SimpleCNN, fire_like, mobilenet_like, params_from_numpy,
    resnet_like, squeezenet_like, tiny_cnn)
from repro_torch.serve.cnn import (  # noqa: F401
    BucketPrograms, CnnServeEngine, ImageRequest)
