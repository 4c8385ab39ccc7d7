"""Faults planted in the program under test, to show that ``correct`` sees
them: ``frozen`` (an optimizer step that leaves the state unchanged),
``half`` (half of a batch left out: only its first half rendered, repeated
in place of the rest, so a loss is the mean over the first half) and
``altered`` (an answer altered where it is produced: each render's
brightest pixel doubled) and ``reversed`` (the pose gradient reversed where
it is produced: each render passes its cotangent back negated, so the
images, the scores and the gradient's size are right and its direction is
not). The exchange between chips does not exist in a
one-chip cell. Used by ``calibrate.py`` and the tests; never by a run."""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen", "half", "altered", "reversed")


def _first_half(fn, batched: tuple):
    def render(self, *args, **kw):
        B = args[batched[-1]].shape[0]
        if B < 2:
            return fn(self, *args, **kw)
        k = B // 2
        cut = [a[:k] if i in batched and a.shape[0] == B else a for i, a in enumerate(args)]
        img = fn(self, *cut, **kw)
        return img.repeat(*([-(-B // k)] + [1] * (img.dim() - 1)))[:B]
    return render


class _Reversed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img):
        return img.view_as(img)

    @staticmethod
    def backward(ctx, g):
        return -g


@contextlib.contextmanager
def planted(fault):
    """Plant ``fault`` (one of ``FAULTS``, or None) for the block."""
    from diffdrr_tpu_torch import DRR

    saved = {}
    try:
        if fault == "frozen":
            saved[(torch.optim.Adam, "step")] = torch.optim.Adam.step
            torch.optim.Adam.step = lambda self, closure=None: None
        elif fault == "half":
            saved[(DRR, "forward")] = DRR.forward
            saved[(DRR, "render")] = DRR.render
            DRR.forward = _first_half(DRR.forward, (0, 1))
            DRR.render = _first_half(DRR.render, (1, 2))
        elif fault == "altered":
            forward = DRR.forward
            saved[(DRR, "forward")] = forward

            def altered(self, *args, **kw):
                img = forward(self, *args, **kw).clone()
                flat = img[0].reshape(-1)
                flat[torch.argmax(flat)] *= 2.0
                return img
            DRR.forward = altered
        elif fault == "reversed":
            forward = DRR.forward
            saved[(DRR, "forward")] = forward
            DRR.forward = lambda self, *args, **kw: _Reversed.apply(forward(self, *args, **kw))
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
