"""The port stands alone: no JAX, no reference package, no silent CPU."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import diffdrr_tpu_torch as T
from diffdrr_tpu_torch import registration
from diffdrr_tpu_torch.experiments import reconstruction
from diffdrr_tpu_torch.experiments import registration as registration_cli

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, diffdrr_tpu_torch, diffdrr_tpu_torch.drr, diffdrr_tpu_torch.interop, "
        "diffdrr_tpu_torch.registration, diffdrr_tpu_torch.metrics, "
        "diffdrr_tpu_torch.ops.kernels.build, diffdrr_tpu_torch.parallel, "
        "diffdrr_tpu_torch.ops.joseph, diffdrr_tpu_torch.ops.trilinear, "
        "diffdrr_tpu_torch.ops.kernels.joseph, diffdrr_tpu_torch.ops.kernels.raymarch, "
        "diffdrr_tpu_torch.checkpoint, diffdrr_tpu_torch.experiments.reconstruction, "
        "diffdrr_tpu_torch.nifti, diffdrr_tpu_torch.data, diffdrr_tpu_torch.detector, "
        "diffdrr_tpu_torch.ops.siddon, diffdrr_tpu_torch.ops._raygeom, "
        "diffdrr_tpu_torch.experiments.registration, diffdrr_tpu_torch.viz, "
        "diffdrr_tpu_torch.meshops, diffdrr_tpu_torch.scene_html, diffdrr_tpu_torch.native, "
        "diffdrr_tpu_torch.native.build, diffdrr_tpu_torch.native.mc_tables, "
        "diffdrr_tpu_torch.experiments.gif\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'click', 'diffdrr_tpu', 'pandas', "
        "'matplotlib', 'imageio'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_names_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|flax|click|diffdrr_tpu)\b")
    # Imported at module level nowhere in the port: only inside the
    # functions (and behind the checks of the tutorials) that need them.
    top_level = re.compile(r"^(import|from)\s+(pandas|matplotlib|imageio)\b")
    for path in list((ROOT / "diffdrr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), f"{path}: {line}"
            assert not top_level.match(line), f"{path}: {line}"


def test_tutorials_import_no_jax():
    """The modules the tutorials import (outside the optional plotting
    libraries, which they import only where installed) pull in nothing of
    JAX or the JAX package."""
    scripts = sorted((ROOT / "diffdrr_tpu_torch" / "tutorials").glob("*.py"))
    assert len(scripts) == 9
    mods = set()
    for script in scripts:
        for node in ast.walk(ast.parse(script.read_text())):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
    mods = sorted(m for m in mods if m.split(".")[0] not in ("matplotlib", "imageio", "pandas"))
    assert "diffdrr_tpu_torch.parallel" in mods and "diffdrr_tpu_torch.viz" in mods
    code = (
        f"import sys\nfor m in {mods!r}:\n    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'click', 'diffdrr_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_native_build_names_no_jax_package_path():
    """The port's native build reads its own sources: its build.py names
    no path under diffdrr_tpu/ and not the JAX package's cache."""
    text = (ROOT / "diffdrr_tpu_torch" / "native" / "build.py").read_text()
    assert not re.search(r"diffdrr_tpu(?!_torch)[/.]", text)
    assert ".cache" not in text and "DIFFDRR_TPU_CACHE" not in text
    for name in ("surface_nets", "marching_cubes", "decimate", "nifti_loader"):
        assert (ROOT / "diffdrr_tpu_torch" / "native" / f"{name}.cpp").is_file()


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.load_example_ct(shape=(8, 8, 4))
    subject = T.load_example_ct(shape=(8, 8, 4), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.DRR(subject, sdd=800.0, height=4, delx=2.0)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        T.DRR(subject, sdd=800.0, height=4, delx=2.0, device="cuda")
    drr = T.DRR(subject, sdd=800.0, height=4, delx=2.0, device="cpu")
    assert drr.density.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    init_fn, _ = registration.make_registration_step(
        drr, torch.zeros(1, 1, 4, 4), "euler_angles", "ZXY")
    params, _ = init_fn(torch.zeros(1, 3), torch.zeros(1, 3))
    assert params["rotation"].device.type == "cpu"
    for renderer in ("joseph", "trilinear"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.DRR(subject, sdd=800.0, height=4, delx=2.0, renderer=renderer)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reconstruction.main(["--volume-size", "16", "--height", "4", "--n-iters", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registration_cli.main(["--volume-size", "16", "--height", "4", "--n-iters", "1"])
