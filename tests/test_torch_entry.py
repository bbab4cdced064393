"""Port entry point and package rules: `brpc_tpu_torch.graft_entry.entry`
against `__graft_entry__.entry`, no JAX in the port, and no hidden
fallback to the CPU."""
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from brpc_tpu_torch import device_path
from brpc_tpu_torch.convert import words_to_numpy
from brpc_tpu_torch.graft_entry import entry
from brpc_tpu_torch.kernels.checksum import adler_frame_checksum_ref

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "brpc_tpu_torch").rglob("*.py"))
PORT_FILES += ["chip_smoke.py", "kernel_times.py"]


def test_entry_matches_jax_entry(monkeypatch):
    import jax

    monkeypatch.syspath_prepend(str(REPO))
    from __graft_entry__ import entry as jax_entry

    fn, (payloads,) = entry(device="cpu")
    jfn, (jpayloads,) = jax_entry()
    np.testing.assert_array_equal(words_to_numpy(payloads),
                                  np.asarray(jpayloads))
    checksums, lengths, echoed = fn(payloads)
    jc, jl, je = jax.jit(jfn)(jpayloads)
    np.testing.assert_array_equal(words_to_numpy(checksums), np.asarray(jc))
    np.testing.assert_array_equal(words_to_numpy(lengths), np.asarray(jl))
    assert echoed is payloads
    # Order-sensitive: reversing one payload's words changes its checksum.
    permuted = words_to_numpy(payloads).copy()
    permuted[0] = permuted[0][::-1]
    c2, _, _ = fn(torch.from_numpy(permuted))
    assert int(c2[0]) != int(checksums[0])


def test_no_cuda_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_path.run(payload_mb=1, reps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(device="cuda")


def test_importing_the_port_pulls_in_no_jax_and_touches_no_device():
    """In a fresh interpreter, importing every module of the port leaves
    jax and brpc_tpu out of sys.modules, initialises no CUDA context and
    loads no shared library."""
    code = (
        "import importlib, json, pkgutil, sys, torch\n"
        "import brpc_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    brpc_tpu_torch.__path__, 'brpc_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from brpc_tpu_torch import native\n"
        "from brpc_tpu_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'brpc_tpu')]\n"
        "print(json.dumps({'mods': mods, 'bad': bad,\n"
        "    'cuda_init': torch.cuda.is_initialized(),\n"
        "    'libs': [native._LIB is not None, _build._LIB is not None]}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "brpc_tpu_torch.device_path" in out["mods"]
    assert "brpc_tpu_torch.kernels.checksum" in out["mods"]
    assert out["bad"] == []
    assert out["cuda_init"] is False
    assert out["libs"] == [False, False]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_source_imports_no_jax(path):
    text = (REPO / path).read_text()
    assert not re.findall(r"^\s*(?:import|from)\s+(?:jax|brpc_tpu)\b", text,
                          flags=re.M)


@pytest.mark.cuda
def test_entry_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device found")
    fn, (payloads,) = entry()
    assert payloads.is_cuda
    checksums, lengths, echoed = fn(payloads)
    np.testing.assert_array_equal(
        words_to_numpy(checksums),
        words_to_numpy(adler_frame_checksum_ref(payloads)))
    assert (words_to_numpy(lengths) == 4096).all()
    assert echoed is payloads
