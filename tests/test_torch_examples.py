"""The examples' twins (``examples_torch/``) run on the CPU with
``--device cpu`` at their smallest size, as a user runs them: each exits
cleanly and prints the reference example's check lines.  The API calls
they make are held to the JAX package by ``test_torch_executors.py``,
``test_torch_autotune.py``, ``test_torch_models.py``,
``test_torch_lm_serve.py`` and ``test_torch_train.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXECUTORS = ["lax", "im2col", "winograd", "cuconv_two_stage",
             "conv1x1_pallas", "cuconv_two_stage_pallas", "cuconv",
             "cuconv_pallas", "winograd_pallas", "direct", "cuconv_int8"]


def _run(tmp_path, twin, *args):
    # one thread: the suite's other workers share the CPU
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_CACHE_DIR=str(tmp_path / "cache"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{twin}.py"),
         *args, "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _floats(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def test_quickstart_twin(tmp_path):
    out = _run(tmp_path, "quickstart")
    assert "output shape: (1, 7, 7, 256)" in out
    errs = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (\w+) +max_err_vs_library = (\S+)", out, re.M)}
    assert sorted(errs) == sorted(EXECUTORS)
    # the executors' bound against the library (tests/test_executors.py)
    # times the output's scale (|out| reaches about 117 here)
    assert errs["lax"] == 0.0 and max(errs.values()) <= 3e-4 * 128
    assert re.search(r"^autotune heuristic: \w+   measured best on this "
                     r"machine: \w+$", out, re.M)
    assert "tuned launch config: conv1x1_pallas cfg[default]=" in out
    assert "tuned launch config: winograd_pallas cfg[measured]=" in out


def test_cnn_inference_twin(tmp_path):
    out = _run(tmp_path, "cnn_inference")
    assert re.search(r"^warmup: ran 10 nodes in \d+ ms$", out, re.M)
    (err,) = _floats(r"logits agree: max_err = (\S+)", out)
    assert err <= 3e-4
    assert len(_floats(r"(?:library|graph-planned) *: (\S+) "
                       r"ms/inference", out)) == 2
    assert ("served 4 requests / 7 images in 4 batches (buckets used: "
            "{1: 3, 4: 1}, padded slots: 0)") in out
    assert ("resnet_like: served 6 images through 2 planned programs with "
            "zero plan() resolutions") in out
    (bf,) = _floats(r"bf16 vs fp32 logits: max_err = (\S+)", out)
    assert 0 < bf < 0.05
    assert ("resnet_like[bf16]: served 6 images through 2 planned bf16 "
            "programs with zero plan() resolutions") in out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_serve_lm_twin(arch, tmp_path):
    out = _run(tmp_path, "serve_lm", "--arch", arch)
    assert re.search(r"^served 10 requests / 120 tokens in ", out, re.M)
    reqs = re.findall(r"^  req (\d+): \[([\d, ]+)\]$", out, re.M)
    assert [int(r) for r, _ in reqs] == list(range(10))
    for _, toks in reqs:
        toks = [int(t) for t in toks.split(",")]
        assert len(toks) == 12 and all(0 <= t < 256 for t in toks)


def test_train_lm_twin(tmp_path):
    ck = tmp_path / "ck"
    out = _run(tmp_path, "train_lm", "--tiny", "--steps", "5",
               "--ckpt-dir", str(ck))
    assert "model: qwen2-1.5b-smoke  params ~0.1M" in out
    assert "[trainer] step 0 loss " in out
    first, last = map(float, re.search(r"loss: first10=(\S+) last10=(\S+)",
                                       out).groups())
    assert 0 < last <= first < 10
    assert sorted(p.name for p in ck.iterdir()) == ["step_5"]
    # auto-resume: a second run finds step 5 and trains on to 7
    out = _run(tmp_path, "train_lm", "--tiny", "--steps", "7",
               "--ckpt-dir", str(ck))
    assert "[trainer] resumed from step 5" in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_5", "step_7"]
