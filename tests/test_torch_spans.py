"""The DRR dispatch's spans, ``drr.pose``, ``drr.render`` and ``drr.sync``,
and ``profiling.annotate`` that opens them, on the CPU.

Under ``torch.profiler`` each call (a Siddon render, a trilinear render, a
batched registration step, a reconstruction step) opens one ``drr.pose``,
then one ``drr.render`` holding one ``drr.sync`` (the march axis and the
slab guard read back); a render with its axis pinned and no slab guard
reads nothing back. With no profiler running ``annotate`` never reaches
``record_function``. On a card (``python -m pytest --noconftest
tests/test_torch_spans.py -m gpu``): each forward kernel starts after the
start of the ``drr.render`` that launched it and after the end of its
``drr.sync``, so the host's spans and the device's kernels share a clock.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffdrr_tpu_torch import DRR, profiling
from diffdrr_tpu_torch.data import load_example_ct
from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d
from diffdrr_tpu_torch.parallel import make_reconstruction_step
from diffdrr_tpu_torch.registration import make_multistart_step

SPANS = ("drr.pose", "drr.render", "drr.sync")
KW = dict(parameterization="euler_angles", convention="ZXY")
ROT = [[0.0, np.pi / 2, 0.0]]
TRANS = [[0.0, 850.0, 0.0]]


def _drr(renderer, device="cpu", shape=(16, 16, 8), height=8, delx=8.0):
    subject = load_example_ct(shape=shape, device=device)
    kw = dict(n_points=6) if renderer == "trilinear" else {}
    return DRR(subject, sdd=1020.0, height=height, delx=delx, renderer=renderer,
               device=device, **kw)


def _pose(device="cpu", n=1):
    rot = torch.tensor(ROT * n, device=device) + 0.01 * torch.arange(n, device=device)[:, None]
    return rot, torch.tensor(TRANS * n, device=device)


def _render(renderer, **opts):
    drr = _drr(renderer)
    rot, trans = _pose()

    def call():
        with torch.no_grad():
            drr(rot, trans, **KW, **opts)

    return drr, call


def _registration_step():
    drr = _drr("trilinear")
    with torch.no_grad():
        target = drr(*_pose(), **KW)
    init_fn, step_fn = make_multistart_step(
        drr, target, **KW, metric=MultiscaleNormalizedCrossCorrelation2d([None], [1.0]),
        optimizer="adam", lr_rotation=5e-3, lr_translation=0.5)
    state = list(init_fn(*_pose(n=3)))

    def call():
        state[0], state[1], scores = step_fn(*state)
        scores.tolist()

    return drr, call


def _reconstruction_step():
    drr = _drr("siddon")
    rot, trans = _pose(n=2)
    with torch.no_grad():
        measured = drr(rot, trans, **KW)
    init_fn, step_fn = make_reconstruction_step(drr, lr=1e-2)
    state = list(init_fn(torch.zeros_like(drr.density)))

    def call():
        state[0], state[1], loss = step_fn(*state, rot, trans, measured)
        loss.item()

    return drr, call


CALLS = {
    "siddon-render": lambda: _render("siddon"),
    "trilinear-render": lambda: _render("trilinear"),
    "multistart-step": _registration_step,
    "reconstruction-step": _reconstruction_step,
}


def _spans(call):
    """The host's ``drr.*`` spans of one call under the profiler, ``name ->
    [(start, end), ...]`` in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    found = {name: [] for name in SPANS}
    for e in prof.events():
        if e.name in found and e.device_type.name == "CPU":
            found[e.name].append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in found.items()}


@pytest.mark.parametrize("case", list(CALLS))
def test_each_call_opens_one_pose_render_and_sync(case):
    drr, call = CALLS[case]()
    call()  # first calls (bricked copies, lazily built state) outside the profile
    spans = _spans(call)
    assert {k: len(v) for k, v in spans.items()} == {k: 1 for k in SPANS}, spans
    (pose,), (render,), (sync,) = spans["drr.pose"], spans["drr.render"], spans["drr.sync"]
    assert pose[1] <= render[0], "drr.pose ends before drr.render starts"
    assert render[0] <= sync[0] <= sync[1] <= render[1], "drr.sync sits inside drr.render"
    assert drr.siddon_escapes == 0  # the kernel path, whose dispatch reads the corner rays


def test_pinned_axis_without_slab_guard_reads_nothing_back():
    drr, call = _render("siddon", axis=1, slab_guard=False)
    call()
    spans = _spans(call)
    assert {k: len(v) for k, v in spans.items()} == {"drr.pose": 1, "drr.render": 1,
                                                      "drr.sync": 0}


def test_annotate_without_a_profiler_opens_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.annotate("drr.render")
    assert first is profiling.annotate("drr.sync") is profiling.annotate("other")
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            pass
    drr, call = _render("siddon")
    call()  # every span of a render, none of them reaching record_function


@pytest.mark.gpu
@pytest.mark.parametrize("renderer,kernel", [("siddon", "siddon_fwd_kernel"),
                                             ("trilinear", "joseph_fwd_kernel")])
def test_kernels_start_after_their_render_and_sync_on_the_card(renderer, kernel):
    """Renders one at a time (each waited for): the i-th forward kernel on
    the device runs inside the i-th ``drr.render``'s turn, after its start and
    after the end of its ``drr.sync``, on the trace's one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    drr = _drr(renderer, device="cuda", shape=(64, 64, 32), height=32, delx=2.0)
    rot, trans = _pose("cuda")
    n = 4
    with torch.no_grad():
        drr(rot, trans, **KW)  # the build and the bricked copy
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                drr(rot, trans, **KW)
                torch.cuda.synchronize()
    host = {name: [] for name in SPANS}
    kernels = []
    for e in prof.events():
        t = (e.time_range.start, e.time_range.end)
        if e.device_type.name == "CPU" and e.name in host:
            host[e.name].append(t)
        elif (e.device_type.name == "CUDA" and kernel in e.name
              and not getattr(e, "is_user_annotation", False)):
            kernels.append(t)
    renders, syncs, kernels = sorted(host["drr.render"]), sorted(host["drr.sync"]), sorted(kernels)
    assert len(renders) == len(syncs) == len(kernels) == n, (renders, syncs, kernels)
    for i, ((r0, _), (_, s1), (k0, _)) in enumerate(zip(renders, syncs, kernels)):
        assert r0 <= k0 and s1 <= k0, (i, renders[i], syncs[i], kernels[i])
        if i + 1 < n:
            assert k0 < renders[i + 1][0], (i, kernels[i], renders[i + 1])
