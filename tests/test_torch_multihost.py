"""The port's ``parallel.multihost`` against the JAX package's, on the CPU.

Two ranks (subprocesses, gloo, a ``file://`` rendezvous in ``tmp_path``)
join through ``initialize_distributed``, take their shares of a global pose
batch, make it one ``DTensor`` and render it with ``make_sharded_render``,
as ``tests/test_multihost.py``'s two JAX processes do; each rank's share of
the image is held against the JAX package's render of the same poses.
The ranks also run the reconstruction CLI's ``--mesh`` with a checkpoint
and a resume. In this process, the single-process shapes of
``test_multihost_shapes_single_process``.

Tolerance: renders on the oracles (``force_xla``, as the JAX DRR renders
on the CPU) 1e-5 * max, as ``tests/test_torch_drr_joseph.py`` holds them.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffdrr_tpu import DRR as JDRR, load_example_ct as jload

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.parallel import (global_mesh, initialize_distributed,
                                        local_batch_to_global, make_sharded_render,
                                        process_local_slice)

REPO = str(Path(__file__).resolve().parent.parent)
KW = dict(parameterization="euler_angles", convention="ZXY")
# tests/test_multihost.py's global batch of 4 poses.
ROTS = np.stack([[0.02 * i, np.pi / 2 + 0.01 * i, -0.015 * i] for i in range(4)]).astype(np.float32)
TRANS = np.stack([[2.0 * i, 300.0 + 5.0 * i, -1.0 * i] for i in range(4)]).astype(np.float32)

WORKER = textwrap.dedent("""
    import os, pickle, sys
    rank, rendezvous, cfg_path, out_path = sys.argv[1:5]
    rank = int(rank)
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from diffdrr_tpu_torch import interop
    from diffdrr_tpu_torch.parallel import (
        global_mesh, initialize_distributed, local_batch_to_global, make_sharded_render,
        process_local_slice)

    initialize_distributed(rendezvous, 2, rank, device="cpu")
    initialize_distributed(rendezvous, 2, rank, device="cpu")  # a second call does nothing
    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    res = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    start, size = process_local_slice(4)
    res["slice"] = (start, size)
    try:
        process_local_slice(3)
    except ValueError as e:
        res["slice_error"] = str(e)
    os.environ["LOCAL_WORLD_SIZE"] = "1"  # one rank a host: (hosts, 1)
    res["mesh_hosts"] = tuple(global_mesh(devices="cpu").shape)
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # both on one host: (1, 2)
    res["mesh_host"] = tuple(global_mesh(devices="cpu").shape)

    mesh = global_mesh((2, 1), ("data", "rays"), devices="cpu")
    rot_g = local_batch_to_global(mesh, ("data",), cfg["rots"][start:start + size])
    tr_g = local_batch_to_global(mesh, ("data",), cfg["trans"][start:start + size])
    res["rot_full"] = rot_g.full_tensor().numpy()
    res["rot_local"] = rot_g.to_local().numpy()
    drr = interop.drr_from_state(cfg["state"], device="cpu", renderer="joseph")
    render = make_sharded_render(drr, mesh, "euler_angles", "ZXY", force_xla=True)
    out = render(rot_g, tr_g)
    res["out_shape"] = tuple(out.shape)
    res["out_local"] = out.to_local().numpy()
    res["out_full"] = out.full_tensor().numpy()
    # One pose a rank over both axes of a (1, 2) mesh: no ray split then.
    mesh2 = global_mesh((1, 2), ("data", "rays"), devices="cpu")
    one = local_batch_to_global(mesh2, (("data", "rays"),), cfg["rots"][rank:rank + 1])
    one_t = local_batch_to_global(mesh2, (("data", "rays"),), cfg["trans"][rank:rank + 1])
    res["one_local"] = make_sharded_render(drr, mesh2, "euler_angles", "ZXY",
                                           force_xla=True)(one, one_t).to_local().numpy()

    # The reconstruction CLI's --mesh on both ranks: (data 2, rays 1); rank 0
    # writes the checkpoints, a resumed run takes its density and Adam state.
    from diffdrr_tpu_torch.experiments import reconstruction as cli
    argv = ["--cpu", "--volume-size", "32", "--height", "16", "--mesh", "--ckpt-every", "2"]
    cli.main(argv + ["--n-iters", "2", "--ckpt-dir", cfg["ckpt"]])
    resumed = cli.main(argv + ["--n-iters", "4", "--ckpt-dir", cfg["ckpt"]])
    straight = cli.main(argv + ["--n-iters", "4"])
    dens, opt = resumed["state"]
    res["cli"] = dict(start=resumed["start"], losses=resumed["losses"],
                      straight=straight["losses"], density=dens.detach().numpy(),
                      straight_density=straight["state"][0].detach().numpy(),
                      exp_avg_sq=opt.state_dict()["state"][0]["exp_avg_sq"].numpy())
    with open(out_path %% rank, "wb") as f:
        pickle.dump(res, f)
    print("rank %%d OK" %% rank, flush=True)
""")


@pytest.fixture(scope="module")
def jscene():
    jd = JDRR(jload(shape=(32, 32, 16)), sdd=600.0, height=16, delx=3.0, renderer="joseph")
    ref = np.asarray(jd(jnp.asarray(ROTS), jnp.asarray(TRANS), **KW))
    return interop.export_state(jd), ref


@pytest.fixture(scope="module")
def two_ranks(jscene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    (tmp / "cfg.pkl").write_bytes(pickle.dumps(dict(state=jscene[0], rots=ROTS, trans=TRANS,
                                                    ckpt=str(tmp / "ckpt"))))
    (tmp / "worker.py").write_text(WORKER % {"repo": REPO})
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r),
                               f"file://{tmp / 'rendezvous'}", str(tmp / "cfg.pkl"),
                               str(tmp / "rank%d.pkl")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    results = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0 and f"rank {r} OK" in out, f"rank {r}:\n{err[-3000:]}"
            results.append(dict(pickle.loads((tmp / f"rank{r}.pkl").read_bytes()), stdout=out,
                                ckpts=sorted(os.listdir(tmp / "ckpt"))))
    finally:
        for p in procs:
            p.kill()
    return results


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def test_two_ranks_join_and_slice(two_ranks):
    for r, res in enumerate(two_ranks):
        assert (res["rank"], res["world"], res["backend"]) == (r, 2, "gloo")
        assert res["slice"] == (2 * r, 2)
        assert res["slice_error"] == "global batch 3 not divisible by 2 processes"


def test_global_mesh_default_layout(two_ranks):
    """Hosts on data, a host's ranks on rays (JAX: processes x local devices)."""
    for res in two_ranks:
        assert res["mesh_hosts"] == (2, 1)
        assert res["mesh_host"] == (1, 2)


def test_local_batch_to_global(two_ranks):
    """Each rank holds only its share; the global tensor is the whole batch."""
    for r, res in enumerate(two_ranks):
        np.testing.assert_array_equal(res["rot_local"], ROTS[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["rot_full"], ROTS)


def test_sharded_render_of_a_global_batch_matches_jax(two_ranks, jscene):
    """test_two_process_sharded_render: each rank's share of the image
    against the JAX package's render of its poses, and the whole batch."""
    ref = jscene[1]
    for r, res in enumerate(two_ranks):
        assert res["out_shape"] == (4, 1, 16, 16)
        _close(res["out_local"], ref[2 * r:2 * r + 2], 1e-5)
        _close(res["out_full"], ref, 1e-5)
        _close(res["one_local"], ref[r:r + 1], 1e-5)


def test_reconstruction_cli_mesh_resumes_every_rank_alike(two_ranks):
    """--mesh on two ranks: only rank 0 prints and checkpoints; the resumed
    run continues the straight one on both ranks, with the same density and
    Adam state bit for bit."""
    r0, r1 = (res["cli"] for res in two_ranks)
    assert "iter    0  mse" in two_ranks[0]["stdout"] and "resumed from step 2" in two_ranks[0][
        "stdout"]
    assert "mse" not in two_ranks[1]["stdout"] and "resumed" not in two_ranks[1]["stdout"]
    assert two_ranks[0]["ckpts"] == ["step_00000002.pt", "step_00000004.pt"]
    for res in (r0, r1):
        assert res["start"] == 2
        np.testing.assert_allclose(res["losses"], res["straight"][2:], rtol=1e-6)
        np.testing.assert_allclose(res["density"], res["straight_density"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(r0["density"], r1["density"])
    np.testing.assert_array_equal(r0["exp_avg_sq"], r1["exp_avg_sq"])


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_multihost_shapes_single_process(world_of_one, jscene):
    """test_multihost_shapes_single_process: one process, the same code shape."""
    initialize_distributed(device="cpu")  # no coordinator, one process: nothing to do
    assert not dist.is_initialized()
    assert process_local_slice(8) == (0, 8)
    mesh = global_mesh((1, 1), ("data", "rays"), devices="cpu")
    assert dist.get_world_size() == 1
    local = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = local_batch_to_global(mesh, ("data",), local)
    np.testing.assert_array_equal(arr.full_tensor().numpy(), local)
    drr = interop.drr_from_state(jscene[0], device="cpu", renderer="joseph")
    rot = local_batch_to_global(mesh, ("data",), ROTS)
    trans = local_batch_to_global(mesh, ("data",), TRANS)
    img = make_sharded_render(drr, mesh, "euler_angles", "ZXY", force_xla=True)(rot, trans)
    assert img.shape == (4, 1, 16, 16) and torch.isfinite(img.to_local()).all()
    _close(img.to_local().numpy(), jscene[1], 1e-5)


def test_initialize_distributed_needs_a_coordinator():
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_distributed("localhost:1234", device="cpu")
    assert not dist.is_initialized()
