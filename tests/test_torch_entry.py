"""The port's entry points (``genomics_rs_tpu_torch/entry.py``) against
``__graft_entry__.py`` on the CPU: ``entry()``'s step gives JAX's score,
start cell and direction table byte for byte, and ``dryrun_multichip``
runs on CPU meshes of 2 and 4 devices (the 2-D step at 4)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from genomics_rs_tpu_torch import entry
from genomics_rs_tpu_torch.ops import traceback_batch as tb
from tests.test_torch_reads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_step_matches_jax():
    fn, args = jax_entry.entry()
    want = fn(*args)
    pfn, pargs = entry.entry("cpu")
    assert all(torch.is_tensor(a) and a.device.type == "cpu" for a in pargs[:2])
    assert pargs[2:] == tuple(int(x) for x in args[2:])
    got = pfn(*pargs)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[3].shape == (513, 257) and got[3].dtype == torch.uint8


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_meshes(n):
    before = tb.COUNTS["diag"]
    entry.dryrun_multichip(n, devices=["cpu"] * n)
    assert tb.COUNTS["diag"] == before  # the scan aligner walks on the host
    with pytest.raises(ValueError, match="requested"):
        entry.dryrun_multichip(n + 1, devices=["cpu"] * n)


def test_entry_needs_cuda_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    proc = subprocess.run([sys.executable, "-m", "genomics_rs_tpu_torch.entry", "--device", "cpu",
                           "-n", "2"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["entry ok: -211", "dryrun_multichip ok"]
