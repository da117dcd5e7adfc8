"""The per-layer readers on hand-made records: ``conv_roofline`` counts
the device time of the port's conv kernels alone, so a library's conv
kernel, which runs a node its numerator leaves out, moves nothing."""
import pytest

from bench import counts, netlist, readers, tracing
from bench.harness import Window

PORT = ("void cuconv_fused_kernel<float, 2, 4>(float const*, float const*)",
        "void winograd_fused_kernel<float>(float const*, float const*)",
        "void conv1x1_tc_kernel<float, 4>(float const*)",
        "void direct_conv_tc_kernel<float>(float const*)",
        "void stage1_tc_kernel<float>(float const*)",
        "void stage2_tap_sum_kernel<float, 4>(float const*)")
LIBRARY = ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>(float*)",
           "void convolve_common_engine_float_NHWC<float, float, 128, 5>()",
           "void cudnn::winograd_nonfused::winogradForwardData4x4<float>()",
           "sm80_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nhwc",
           "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8")


@pytest.mark.parametrize("name", PORT)
def test_port_kernels_are_counted(name):
    assert counts.is_port_conv_kernel(name)


@pytest.mark.parametrize("name", LIBRARY)
def test_library_kernels_are_not(name):
    assert not counts.is_port_conv_kernel(name)


class FakeTrace:
    kernel_s = tracing.Trace.kernel_s

    def __init__(self, records):
        self.records = {0: records}


class Batch:
    def __init__(self, bucket, units):
        self.bucket, self.units = bucket, units


def window(records):
    cfg = netlist.load("resnet50-fp32")
    nodes = frozenset(n["name"] for n in cfg["nodes"]
                      if n["op"] == "conv" and n["name"] != "conv1")
    return Window(cfg=cfg, cards=1, image=(32, 32, 3),
                  batches=[Batch(4, 4)] * 3, kernel_nodes={4: nodes},
                  trace=FakeTrace(records))


def test_a_library_conv_kernel_leaves_conv_roofline_alone():
    port = [(PORT[0], 0.0, 2e-3), (PORT[1], 2e-3, 3e-3)]
    alone = readers.conv_roofline(window(port))
    stem = [(LIBRARY[1], 3e-3, 4e-3), (LIBRARY[2], 4e-3, 5e-3)]
    assert readers.conv_roofline(window(port + stem)) == alone
    slower = [(PORT[0], 0.0, 5e-3), (PORT[1], 5e-3, 6e-3)]
    assert readers.conv_roofline(window(slower)) == pytest.approx(alone / 2)
    least = 3 * sum(c["least_s"] for c in counts.conv_nodes(
        window([]).cfg, 4, (32, 32, 3)) if c["name"] != "conv1")
    assert alone == pytest.approx(100.0 * least / 3e-3)


def test_no_port_kernel_reads_nothing():
    assert readers.conv_roofline(window([(LIBRARY[1], 0.0, 1e-3)])) is None
