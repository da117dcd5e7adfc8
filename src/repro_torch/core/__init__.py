"""Conv geometry, the planner, the executor registry and the graph layer."""
from repro_torch.core.cuconv import (  # noqa: F401
    conv2d, cuconv_stage1, cuconv_stage2)
from repro_torch.core.convspec import ConvSpec, ConvPlan, plan  # noqa: F401
from repro_torch.core.executors import (  # noqa: F401
    ALGORITHMS, Executor, register, unregister)
from repro_torch.core.graph import (  # noqa: F401
    AddOp, ConcatOp, ConvGraph, ConvOp, DenseOp, GapOp, Graph,
    GraphBuilder, GraphPlan, PoolOp, PrecisionPolicy, plan_graph)
