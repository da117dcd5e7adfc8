"""The per-layer metrics' arithmetic; each ``metrics/<name>.py`` binds
one of these as its ``read``.  A reader takes a ``harness.Window`` and
returns a number, or None where the window holds nothing to read.

Records of the front end (``serve/telemetry.py``): a batch records its
bucket and its real images (``units``).  Device figures come
from the trace of the whole traced region (the window, then ``run()``
serving what was still queued), so every batch dispatched in it is
whole in it.
"""
from __future__ import annotations

from typing import Optional

from bench import counts


def _images(w) -> int:
    return sum(b.units for b in w.batches)


def device_ms_per_image(w) -> Optional[float]:
    if w.trace is None or not _images(w):
        return None
    busy = sum(w.trace.busy_s(d) for d in w.trace.busy)
    return 1e3 * busy / _images(w) if busy else None


def _least_s(w, take) -> float:
    """The least time of the conv nodes on the port's kernels whose
    executor's kernels (launch names) ``take`` accepts, over the traced
    region's batches: each batch of bucket ``b`` runs every card's plan
    at ``b / cards``."""
    least, per_bucket = 0.0, {}
    for b in w.batches:
        if b.bucket not in per_bucket:
            nodes = w.kernel_nodes[b.bucket]
            kernels = w.node_kernels.get(b.bucket, {})
            per_bucket[b.bucket] = w.cards * sum(
                c["least_s"] for c in counts.conv_nodes(
                    w.cfg, b.bucket // w.cards, w.image)
                if c["name"] in nodes and take(kernels.get(c["name"], ())))
        least += per_bucket[b.bucket]
    return least


def _known(kernels) -> bool:
    return all(k in counts.KERNEL_OF_LAUNCH for k in kernels)


def conv_roofline(w) -> Optional[float]:
    """The least time of the conv nodes that ran on the port's conv
    kernels, over the device time of those kernels alone (a library's
    conv kernels run the nodes left out of the numerator).  A node whose
    executor launches a kernel that ``counts.KERNEL_OF_LAUNCH`` does not
    know is left out, as that kernel's time is."""
    if w.trace is None:
        return None
    spent = w.trace.kernel_s(counts.is_port_conv_kernel)
    if not spent:
        return None
    return 100.0 * _least_s(w, _known) / spent


def kernel_roofline(w, launch: str) -> Optional[float]:
    """``conv_roofline`` of one port kernel: the least time of the conv
    nodes whose executor launches kernel ``launch`` alone, over that
    kernel's device time.  Over kernels that each run their nodes alone,
    the shares recombine to ``conv_roofline``: the sum of their least
    times over the sum of their times."""
    if w.trace is None:
        return None
    spent = w.trace.kernel_s(counts.kernel_of(launch))
    least = _least_s(w, lambda kernels: tuple(kernels) == (launch,))
    if not spent or not least:
        return None
    return 100.0 * least / spent


def mfu(w) -> Optional[float]:
    """Direct-conv and dense FLOPs of the real images served in the
    traced region, over its length at the cards' 3xTF32 peak."""
    if w.trace is None or not _images(w):
        return None
    flops = counts.flops_per_image(w.cfg, w.image) * _images(w)
    return 100.0 * flops / (w.trace.window_s * counts.PEAK_FLOPS * w.cards)


def idle_share(w) -> Optional[float]:
    if w.trace is None:
        return None
    n = w.cards
    return 100.0 * sum(1.0 - w.trace.busy_s(d) / w.trace.window_s
                       for d in range(n)) / n
