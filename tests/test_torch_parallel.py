"""The port's ``parallel`` package against the JAX package's, on the CPU.

Each rank is a subprocess (gloo on the CPU, a ``file://`` rendezvous in
``tmp_path``, one thread) running ``WORKER``, which imports only the port
and NumPy and saves its results; worlds of 2 and 4 ranks are spawned once
for the module. The JAX side runs in this process on the conftest's virtual
CPU devices, on a mesh of the same shape as the ranks', so both split the
rays, poses and slabs at the same boundaries. On the CPU the port's kernel
paths run the kernels' plain versions.

Tolerances (``tests/test_sharding.py``'s, and the port's own):
  * a sharded render against the unsharded port render: bit for bit
    (each rank cuts its block of poses and rays from the whole batch's
    rays, and every choice comes from the whole set);
  * renders against the JAX package: rtol 1e-4, atol 1e-5 (oracles);
    Siddon's kernels against its sort oracle 1e-3 * max
    (``tests/test_torch_siddon.py``); pose gradients rtol 1e-3, atol 1e-5 of
    their largest entry;
  * slab renders: values rtol 1e-4, atol 1e-4 * max (the raycast rtol 1e-3,
    atol 1e-4); gradients to source, target and the assembled volume rtol
    1e-3, atol 1e-4 * max;
  * the reconstruction step: losses rtol 1e-3 and the density after 3
    steps to 1e-3 * lr on voxels with a real gradient
    (``tests/test_torch_siddon_bwd.py``'s rule) against JAX; losses rtol
    1e-5 against the port on one device; the density bitwise equal on
    every rank.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.joseph import joseph_raycast as jjoseph
from diffdrr_tpu.ops.siddon import siddon_raycast as jsiddon
from diffdrr_tpu.ops.trilinear import trilinear_raycast as jtrilinear
from diffdrr_tpu.parallel import (make_mesh as jmake_mesh, make_reconstruction_step as jrecon,
                                  make_sharded_render as jrender, slab_sharded_joseph as jslab_j,
                                  slab_sharded_raycast as jslab_r, slab_sharded_siddon as jslab_s)

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.parallel import (make_mesh, make_reconstruction_step,
                                        slab_sharded_joseph, slab_sharded_siddon)

REPO = str(Path(__file__).resolve().parent.parent)
KW = dict(parameterization="euler_angles", convention="ZXY")
WORLDS = (2, 4)
# Render meshes (data, rays) per world: rays only, data only, both.
MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (4, 1), (2, 2)]}
RECON_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
RENDERERS = ("trilinear", "joseph", "siddon")
OPTS = {"trilinear": dict(n_points=100), "joseph": {}, "siddon": {}}
# Four generic poses about test_sharding.py's [0, pi/2, 0], [0, 300, 0].
ROT = (np.array([[0.0, np.pi / 2, 0.0]], np.float32)
       + np.array([[0.013, 0.017, -0.011], [0.021, -0.009, 0.007],
                   [-0.012, 0.011, 0.019], [0.008, -0.016, -0.005]], np.float32))
TRANS = (np.array([[0.0, 300.0, 0.0]], np.float32)
         + np.array([[1.7, 0.3, -1.1], [-0.9, 1.4, 0.6], [0.4, -1.2, 1.3], [1.1, 0.8, -0.7]],
                    np.float32))
# Slab poses: "main" marches axis 2 (Siddon's major axis there), "lateral" axis 0.
SLAB_POSES = {"main": (ROT[:2] + 0.011, TRANS[:2] + 1.3),
              "lateral": (np.array([[np.pi / 2 + 0.013, 0.011, -0.009]] * 2, np.float32)
                          + np.array([[0.0, 0.0, 0.0], [0.007, -0.01, 0.004]], np.float32),
                          TRANS[:2])}
SLAB_CASES = [  # (function, axis, use_pallas, pose)
    ("joseph", 0, False, "main"), ("joseph", 2, False, "main"),
    ("joseph", 0, True, "main"), ("joseph", 2, True, "main"),
    ("siddon", 0, False, "main"), ("siddon", 2, False, "main"),
    ("siddon", 2, True, "main"), ("siddon", 0, True, "lateral"),
]
RECON_THETAS = np.linspace(0, np.pi, 4, endpoint=False)
RECON_ROT = np.stack([RECON_THETAS, np.full(4, np.pi / 2), np.zeros(4)], 1).astype(np.float32)
RECON_TRANS = np.tile(np.array([[0.0, 850.0, 0.0]], np.float32), (4, 1))
RECON_LR = 5e-2
RECON_STEPS = 3

WORKER = textwrap.dedent("""
    import pickle, sys
    rank, world, rendezvous, cfg_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from diffdrr_tpu_torch import interop
    from diffdrr_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_reconstruction_step, make_sharded_render,
        shard_drr, slab_sharded_joseph, slab_sharded_raycast, slab_sharded_siddon)

    initialize_distributed(rendezvous, world, rank, device="cpu")
    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    t = lambda x, grad=False: torch.tensor(np.asarray(x), requires_grad=grad)
    kw = cfg["kw"]
    res = {}

    # Sharded renders, each renderer, each mesh; the kernel path and the oracles.
    for renderer in cfg["renderers"]:
        drr = interop.drr_from_state(cfg["state"], device="cpu", renderer=renderer)
        opts = cfg["opts"][renderer]
        rot, trans = t(cfg["rot"]), t(cfg["trans"])
        for shape in cfg["meshes"]:
            mesh = make_mesh(shape, devices="cpu")
            for xla in (False, True):
                render = make_sharded_render(drr, mesh, force_xla=xla, **opts, **kw)
                res[f"render/{renderer}/{shape}/{xla}"] = render(rot, trans).numpy()
        # shard_drr's pose gradient (rays split over every rank).
        sharded = shard_drr(drr, make_mesh((1, world), devices="cpu"))
        for xla in (False, True):
            r = t(cfg["rot"][:2], True)
            img = sharded(r, t(cfg["trans"][:2]), force_xla=xla, **opts, **kw)
            torch.sum(img ** 2).backward()
            res[f"grad/{renderer}/{xla}"] = r.grad.numpy()
        # make_sharded_render's pose gradient with the poses split over data.
        mesh = make_mesh((2, world // 2), devices="cpu")
        for xla in (False, True):
            render = make_sharded_render(drr, mesh, force_xla=xla, **opts, **kw)
            r = t(cfg["rot"][:2], True)
            torch.sum(render(r, t(cfg["trans"][:2])) ** 2).backward()
            res[f"datagrad/{renderer}/{xla}"] = r.grad.numpy()

    # Slab renders on a 1-D mesh of every rank: values and gradients.
    mesh = make_mesh((world,), ("rays",), devices="cpu")
    c = t(cfg["cotangent"])
    for pose, (sv, tv, w) in cfg["slab_rays"].items():
        cases = [("raycast", 0, False)] if pose == "main" else []
        cases += [(fn, ax, k) for fn, ax, k, p in cfg["slab_cases"] if p == pose]
        for fn, ax, kernel in cases:
            vol, S, T = t(cfg["state"]["density"], True), t(sv, True), t(tv, True)
            if fn == "raycast":
                img = slab_sharded_raycast(vol, S, T, t(w), mesh, n_points=100)
            elif fn == "joseph":
                img = slab_sharded_joseph(vol, S, T, t(w), mesh, march_axis=ax,
                                          use_pallas=kernel)
            else:
                img = slab_sharded_siddon(vol, S, T, t(w), mesh, slab_axis=ax, use_pallas=kernel)
            torch.sum(img * c).backward()
            n = vol.shape[ax] // world
            key = f"slab/{fn}/{ax}/{kernel}"
            res[key] = img.detach().numpy()
            res[key + "/source"], res[key + "/target"] = S.grad.numpy(), T.grad.numpy()
            res[key + "/volume"] = vol.grad.narrow(ax, rank * n, n).numpy()
            res[key + "/volume_rest"] = (np.count_nonzero(vol.grad.numpy())
                                         - np.count_nonzero(res[key + "/volume"]))

    # Indivisible slabs raise in the JAX package's words.
    odd = torch.zeros((4 * world + 1, 8, 8))
    rays = t(cfg["slab_rays"]["main"][0]), t(cfg["slab_rays"]["main"][1])
    for fn in (slab_sharded_raycast, slab_sharded_joseph, slab_sharded_siddon):
        try:
            fn(odd, *rays, None, mesh)
        except ValueError as e:
            res[f"raises/{fn.__name__}"] = str(e)

    # The sharded reconstruction step (Siddon), 3 steps from zero.
    drr = interop.drr_from_state(cfg["recon_state"], device="cpu")
    for shape in cfg["recon_meshes"]:
        mesh = make_mesh(shape, devices="cpu")
        init_fn, step_fn = make_reconstruction_step(drr, mesh, lr=cfg["lr"])
        density, opt = init_fn(torch.zeros_like(drr.density))
        losses = []
        for _ in range(cfg["steps"]):
            density, opt, loss = step_fn(density, opt, t(cfg["recon_rot"]),
                                         t(cfg["recon_trans"]), t(cfg["measured"]))
            losses.append(loss.item())
            res.setdefault(f"recon/{shape}/density_steps", []).append(
                density.detach().numpy().copy())
        res[f"recon/{shape}/losses"] = np.asarray(losses)
    res = {k: np.asarray(v) for k, v in res.items()}
    np.savez(out_path %% rank, **res)
    print("rank %%d OK" %% rank, flush=True)
""")


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


@pytest.fixture(scope="module")
def scene():
    """test_sharding.py's scene (32x32x16 phantom, 16x16 detector) and the
    reconstruction scene of test_torch_siddon_bwd.py (64x64x32, 32x32, 4
    views), with the voxel-space rays of the slab poses."""
    jd = JDRR(jload(shape=(32, 32, 16)), sdd=600.0, height=16, delx=4.0, renderer="trilinear")
    slab_rays = {}
    for name, (rot, trans) in SLAB_POSES.items():
        src, tgt = jd.detector(jconvert(jnp.asarray(rot), jnp.asarray(trans), **KW), None)
        w = jnp.linalg.norm(tgt - src, axis=-1)[:, None, :]
        slab_rays[name] = (np.asarray(jd.affine_inverse(src)), np.asarray(jd.affine_inverse(tgt)),
                           np.asarray(w))
    jr = JDRR(jload(shape=(64, 64, 32)), sdd=1020.0, height=32, delx=3.0)
    measured = np.asarray(jr(jnp.asarray(RECON_ROT), jnp.asarray(RECON_TRANS), **KW))
    cotangent = np.random.default_rng(0).normal(size=(2, 1, 256)).astype(np.float32)
    return dict(jd=jd, state=interop.export_state(jd), slab_rays=slab_rays, jr=jr,
                recon_state=interop.export_state(jr), measured=measured, cotangent=cotangent)


def _value_and_pullback(f, args, cotangent):
    """``f(*args)`` and the gradients of ``sum(f(*args) * cotangent)``."""
    value, pullback = jax.vjp(f, *args)
    return value, pullback(cotangent)


def _spawn(tmp: Path, world: int, scene) -> list:
    cfg = dict(kw=KW, renderers=RENDERERS, opts=OPTS, rot=ROT, trans=TRANS, meshes=MESHES[world],
               state=scene["state"], slab_rays=scene["slab_rays"], slab_cases=SLAB_CASES,
               cotangent=scene["cotangent"], recon_state=scene["recon_state"],
               recon_meshes=RECON_MESHES[world], recon_rot=RECON_ROT, recon_trans=RECON_TRANS,
               measured=scene["measured"], lr=RECON_LR, steps=RECON_STEPS)
    (tmp / "cfg.pkl").write_bytes(pickle.dumps(cfg))
    (tmp / "worker.py").write_text(WORKER % {"repo": REPO})
    out = str(tmp / "rank%d.npz")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    return [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), str(world),
                              f"file://{tmp / 'rendezvous'}", str(tmp / "cfg.pkl"), out],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """(the ranks' results {world: [each rank's]}, the JAX references, the
    port on one device); both worlds' ranks run while this process computes
    the other two."""
    procs = {w: _spawn(tmp_path_factory.mktemp(f"world{w}"), w, scene) for w in WORLDS}
    try:
        jref, one = _jax_ref(scene), _single(scene)
        results = {}
        for w, ps in procs.items():
            for r, p in enumerate(ps):
                out, err = p.communicate(timeout=300)
                assert p.returncode == 0 and f"rank {r} OK" in out, f"rank {r}:\n{err[-3000:]}"
            base = Path(ps[0].args[5]).parent
            results[w] = [dict(np.load(base / f"rank{r}.npz")) for r in range(w)]
    finally:
        for p in (p for ps in procs.values() for p in ps):
            p.kill()
    return results, jref, one


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


@pytest.fixture(scope="module")
def single(runs):
    return runs[2]


def _jax_ref(scene):
    """The JAX package's sharded renders, slab renders and reconstruction
    steps on meshes of the ranks' shapes, and its unsharded renders."""
    jd, ref = scene["jd"], {}
    rot, trans = jnp.asarray(ROT), jnp.asarray(TRANS)
    for renderer in RENDERERS:
        d = JDRR(jd.subject, sdd=600.0, height=16, delx=4.0, renderer=renderer)
        # Under jit: eager JAX dispatches op by op, ~100x slower here.
        ref[f"plain/{renderer}"] = np.asarray(jax.jit(
            lambda r, t, d=d, o=OPTS[renderer]: d(r, t, **o, **KW))(rot, trans))
        for w in WORLDS:
            for shape in MESHES[w]:
                mesh = jmake_mesh(shape, devices=jax.devices()[:w])
                render = jrender(d, mesh, "euler_angles", "ZXY", **OPTS[renderer])
                ref[f"render/{renderer}/{shape}"] = np.asarray(render(rot, trans))

        def loss(r, d=d, renderer=renderer):
            return jnp.sum(d(r, trans[:2], **OPTS[renderer], **KW) ** 2)

        ref[f"grad/{renderer}"] = np.asarray(jax.jit(jax.grad(loss))(rot[:2]))
    c = jnp.asarray(scene["cotangent"])
    for pose, (sv, tv, w) in scene["slab_rays"].items():
        cases = [("raycast", 0, False)] if pose == "main" else []
        cases += [(fn, ax, k) for fn, ax, k, p in SLAB_CASES if p == pose]
        args = (jd.density, jnp.asarray(sv), jnp.asarray(tv))
        for fn, ax, kernel in cases:
            for world in WORLDS:
                mesh = jmake_mesh((world,), ("rays",), devices=jax.devices()[:world])
                key = f"slab/{fn}/{ax}/{kernel}"
                if kernel and world != WORLDS[0]:  # unsharded: as the first world's
                    for k in [k for k in ref if k.startswith(f"{key}/{WORLDS[0]}")]:
                        ref[k.replace(f"{key}/{WORLDS[0]}", f"{key}/{world}")] = ref[k]
                    continue
                if kernel:  # the kernels against the unsharded XLA render
                    f = ((lambda v, s, t: jjoseph(v, s, t, w, axis=ax)) if fn == "joseph"
                         else (lambda v, s, t: jsiddon(v, s, t, w)))
                elif fn == "raycast":
                    f = lambda v, s, t: jslab_r(v, s, t, w, mesh, n_points=100)  # noqa: E731
                elif fn == "joseph":
                    f = lambda v, s, t: jslab_j(v, s, t, w, mesh, march_axis=ax)  # noqa: E731
                else:
                    f = lambda v, s, t: jslab_s(v, s, t, w, mesh, slab_axis=ax)  # noqa: E731
                value, grads = jax.jit(lambda *a, f=f: _value_and_pullback(f, a, c))(*args)
                ref[f"{key}/{world}"] = np.asarray(value)
                for name, g in zip(("volume", "source", "target"), grads):
                    ref[f"{key}/{world}/{name}"] = np.asarray(g)
    ref["slab/unsharded/trilinear"] = np.asarray(jtrilinear(
        jd.density, *map(jnp.asarray, scene["slab_rays"]["main"]), n_points=100))
    jr, rrot, rtrans = scene["jr"], jnp.asarray(RECON_ROT), jnp.asarray(RECON_TRANS)
    for w in WORLDS:
        for shape in RECON_MESHES[w]:
            mesh = jmake_mesh(shape, devices=jax.devices()[:w])
            init_fn, step_fn = jrecon(jr, mesh, lr=RECON_LR)
            dens, state = init_fn(jnp.zeros_like(jr.density))
            losses = []
            for _ in range(RECON_STEPS):
                dens, state, loss = step_fn(dens, state, rrot, rtrans, jnp.asarray(
                    scene["measured"]))
                losses.append(float(loss))
            ref[f"recon/{shape}/losses"] = np.asarray(losses)
            ref[f"recon/{shape}/density"] = np.asarray(dens)
    return ref


def _single(scene):
    """The port on one device: the unsharded renders and pose gradients,
    and the reconstruction's losses, densities and per-step gradients."""
    out = {}
    for renderer in RENDERERS:
        d = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer)
        for xla in (False, True):
            out[f"render/{renderer}/{xla}"] = d(torch.tensor(ROT), torch.tensor(TRANS),
                                                force_xla=xla, **OPTS[renderer], **KW).numpy()
            r = torch.tensor(ROT[:2], requires_grad=True)
            torch.sum(d(r, torch.tensor(TRANS[:2]), force_xla=xla, **OPTS[renderer],
                        **KW) ** 2).backward()
            out[f"grad/{renderer}/{xla}"] = r.grad.numpy()
    drr = interop.drr_from_state(scene["recon_state"], device="cpu")
    init_fn, step_fn = make_reconstruction_step(drr, lr=RECON_LR)
    dens, opt = init_fn(torch.zeros_like(drr.density))
    losses, grads = [], []
    for _ in range(RECON_STEPS):
        dens, opt, loss = step_fn(dens, opt, torch.tensor(RECON_ROT), torch.tensor(RECON_TRANS),
                                  torch.tensor(scene["measured"]))
        losses.append(loss.item())
        grads.append(dens.grad.numpy().copy())
    out["recon/losses"], out["recon/grads"] = np.asarray(losses), grads
    out["recon/density"] = dens.detach().numpy()
    return out


def _cases(table):
    return [(w, s) for w in WORLDS for s in table[w]]


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("world,shape", _cases(MESHES))
def test_sharded_render_matches_single_device(ranks, single, world, shape, renderer):
    """Every rank returns the whole image: the unsharded render bit for
    bit, on the kernel path and on the oracles, whichever axes split."""
    for xla in (False, True):
        ref = single[f"render/{renderer}/{xla}"]
        for r in range(world):
            np.testing.assert_array_equal(ranks[world][r][f"render/{renderer}/{shape}/{xla}"], ref)


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("world,shape", _cases(MESHES))
def test_sharded_render_matches_jax(ranks, jax_ref, world, shape, renderer):
    """test_ray_sharded_render_matches_single and
    test_sharded_render_production_joseph: the port's sharded render
    against the JAX package's on a mesh of the same shape. The JAX DRR
    renders on its oracles on the CPU, so the port's oracles (force_xla)
    are held to it at its tolerance, and Siddon's kernels at theirs."""
    ref = jax_ref[f"render/{renderer}/{shape}"]
    np.testing.assert_allclose(ref, jax_ref[f"plain/{renderer}"], rtol=1e-4, atol=1e-5)
    for r in range(world):
        if renderer == "siddon":
            _close(ranks[world][r][f"render/siddon/{shape}/False"], ref, 1e-3)
        np.testing.assert_allclose(ranks[world][r][f"render/{renderer}/{shape}/True"], ref,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_pose_gradient_over_data(ranks, single, jax_ref, world, renderer):
    """The pose gradient through make_sharded_render with the two poses
    split over ``data`` (mesh (2, world / 2)) is the unsharded one on every
    rank (not world-size times it), and the JAX package's."""
    g_jax = jax_ref[f"grad/{renderer}"]
    for r in range(world):
        for xla in (False, True):
            got, ref = ranks[world][r][f"datagrad/{renderer}/{xla}"], single[f"grad/{renderer}/{xla}"]
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * np.abs(ref).max())
        got = ranks[world][r][f"datagrad/{renderer}/True"]
        np.testing.assert_allclose(got, g_jax, rtol=1e-3, atol=1e-5 * np.abs(g_jax).max())


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("world", WORLDS)
def test_shard_drr_render_gradients(ranks, single, jax_ref, world, renderer):
    """The pose gradient through a ray-sharded render is the unsharded one
    on every rank (not world-size times it), and the JAX package's."""
    g_jax = jax_ref[f"grad/{renderer}"]
    for r in range(world):
        for xla in (False, True):
            got, ref = ranks[world][r][f"grad/{renderer}/{xla}"], single[f"grad/{renderer}/{xla}"]
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * np.abs(ref).max())
        got = ranks[world][r][f"grad/{renderer}/True"]
        np.testing.assert_allclose(got, g_jax, rtol=1e-3, atol=1e-5 * np.abs(g_jax).max())


def _slab_parts(ranks, world, key):
    """The slab render's value, its rays' gradients (from rank 0) and the
    volume gradient assembled from every rank's slab."""
    _, ax, _ = key.split("/")[1:4]
    parts = [ranks[world][r] for r in range(world)]
    for p in parts:  # each rank's volume gradient lies in its own slab
        assert p[key + "/volume_rest"] == 0
        np.testing.assert_array_equal(p[key], parts[0][key])
    volume = np.concatenate([p[key + "/volume"] for p in parts], axis=int(ax))
    return parts[0], volume


@pytest.mark.parametrize("world", WORLDS)
def test_slab_sharded_raycast_matches_jax(ranks, jax_ref, world):
    """test_slab_sharded_matches_replicated: values and gradients."""
    key = "slab/raycast/0/False"
    rank0, volume = _slab_parts(ranks, world, key)
    ref = jax_ref[f"{key}/{world}"]
    np.testing.assert_allclose(rank0[key], ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(rank0[key], jax_ref["slab/unsharded/trilinear"], rtol=1e-3,
                               atol=1e-4)
    for name, got in (("source", rank0[key + "/source"]), ("target", rank0[key + "/target"]),
                      ("volume", volume)):
        g = jax_ref[f"{key}/{world}/{name}"]
        np.testing.assert_allclose(got, g, rtol=1e-3, atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("fn,ax,kernel,pose", SLAB_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_slab_sharded_joseph_and_siddon_match_jax(ranks, jax_ref, world, fn, ax, kernel, pose):
    """test_slab_sharded_joseph_matches_replicated,
    test_slab_sharded_siddon_matches_replicated and the two Pallas-kernel
    tests: the oracle path against the JAX package's slab render on the same
    mesh, the kernel path (use_pallas=True) against its unsharded XLA
    render, values and the gradients to source, target and the volume."""
    key = f"slab/{fn}/{ax}/{kernel}"
    rank0, volume = _slab_parts(ranks, world, key)
    ref = jax_ref[f"{key}/{world}"]
    np.testing.assert_allclose(rank0[key], ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    for name, got in (("source", rank0[key + "/source"]), ("target", rank0[key + "/target"]),
                      ("volume", volume)):
        g = jax_ref[f"{key}/{world}/{name}"]
        np.testing.assert_allclose(got, g, rtol=1e-3, atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("world", WORLDS)
def test_slab_sharding_raises_when_indivisible(ranks, world):
    msgs = ranks[world][0]
    n = 4 * world + 1
    assert str(msgs["raises/slab_sharded_raycast"]) == (
        f"volume x-dim {n} not divisible by mesh axis {world}")
    assert str(msgs["raises/slab_sharded_joseph"]) == (
        f"march axis {n} not divisible by mesh axis {world}")
    assert str(msgs["raises/slab_sharded_siddon"]) == (
        f"slab axis {n} not divisible by mesh axis {world}")


@pytest.mark.parametrize("world,shape", _cases(RECON_MESHES))
def test_sharded_reconstruction_step_matches_jax(ranks, jax_ref, single, world, shape):
    """test_distributed_reconstruction_step_descends, held to the JAX
    package's step on the same mesh: losses, and the density after 3 steps
    on the voxels whose gradient exceeds 1e-3 * max at every step."""
    got = ranks[world][0]
    np.testing.assert_allclose(got[f"recon/{shape}/losses"], jax_ref[f"recon/{shape}/losses"],
                               rtol=1e-3)
    assert got[f"recon/{shape}/losses"][-1] < got[f"recon/{shape}/losses"][0]
    mask = np.ones(single["recon/density"].shape, bool)
    for g in single["recon/grads"]:
        mask &= np.abs(g) > 1e-3 * np.abs(g).max()
    assert mask.sum() > 1000
    ref = jax_ref[f"recon/{shape}/density"]
    np.testing.assert_allclose(got[f"recon/{shape}/density_steps"][-1][mask], ref[mask],
                               atol=1e-3 * RECON_LR, rtol=0)


@pytest.mark.parametrize("world,shape", _cases(RECON_MESHES))
def test_sharded_reconstruction_matches_single_device(ranks, single, world, shape):
    """The global mean of the split squared errors is the one-device loss,
    and every rank holds the same density, bit for bit, after every step."""
    for r in range(world):
        got = ranks[world][r]
        np.testing.assert_allclose(got[f"recon/{shape}/losses"], single["recon/losses"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got[f"recon/{shape}/density_steps"],
                                      ranks[world][0][f"recon/{shape}/density_steps"])


@pytest.fixture
def world_of_one():
    """A plain process: make_mesh wires a world of one itself; torn down after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_in_a_plain_process(world_of_one):
    mesh = make_mesh(devices="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("data", "rays") and tuple(mesh.shape) == (1, 1)
    assert tuple(make_mesh((1,), ("rays",), devices="cpu").shape) == (1,)
    with pytest.raises(ValueError, match="torchrun.*initialize_distributed"):
        make_mesh((2, 4), devices="cpu")


def test_slab_tile_plan_has_no_counterpart(world_of_one, scene):
    mesh = make_mesh((1,), ("rays",), devices="cpu")
    sv, tv, w = (torch.tensor(x) for x in scene["slab_rays"]["main"])
    vol = torch.tensor(scene["state"]["density"])
    one = slab_sharded_joseph(vol, sv, tv, w, mesh, march_axis=0, use_pallas=True,
                              image_shape=(16, 16))
    assert one.shape == (2, 1, 256)
    for fn, kw in ((slab_sharded_joseph, dict(march_axis=0)), (slab_sharded_siddon, {})):
        with pytest.raises(TypeError, match="tile"):
            fn(vol, sv, tv, w, mesh, use_pallas=True, image_shape=(16, 16),
               pallas_kwargs=dict(tile=16, ky=64), **kw)
        with pytest.raises(ValueError, match="image_shape"):
            fn(vol, sv, tv, w, mesh, use_pallas=True, image_shape=(8, 8), **kw)
