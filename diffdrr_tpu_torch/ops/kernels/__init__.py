"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions."""


# Counts that are a part of a kernel's count, not a kernel of their own:
# joseph_fwd's float32 launches in blend mode (a fractional stride).
SUBCOUNTS = ("joseph_fwd_blend",)


def launch_counts() -> dict:
    """Every wrapper's launch count by kernel name (``brick_copy`` for the
    bricked copy; ``<name>_bf16`` for a bf16 instantiation), and the
    ``SUBCOUNTS``; a wrapper counts only where it launches its kernel."""
    from . import brick, joseph, siddon

    counts = {fn.__name__: fn.launches for fn in siddon.KERNELS + joseph.KERNELS}
    counts.update({f"{fn.__name__}_bf16": fn.launches_bf16
                   for fn in siddon.BF16_KERNELS + joseph.BF16_KERNELS})
    return dict(counts, brick_copy=brick.brick_density.launches,
                brick_copy_bf16=brick.brick_density.launches_bf16,
                joseph_fwd_blend=joseph.joseph_fwd.launches_blend)


def reset_launch_counts() -> None:
    from . import brick, joseph, siddon

    siddon.reset_launch_counts()
    joseph.reset_launch_counts()
    brick.brick_density.launches = brick.brick_density.launches_bf16 = 0


def no_other_launches(phase: str, launches: dict, want: dict) -> None:
    """Raise unless ``launches`` is ``want`` exactly and 0 for every other
    kernel; a ``SUBCOUNTS`` entry is held only where ``want`` names it."""
    bad = {k: (launches.get(k, 0), want.get(k, 0)) for k in {**launches, **want}
           if launches.get(k, 0) != want.get(k, 0) and (k in want or k not in SUBCOUNTS)}
    if bad:
        raise AssertionError(f"{phase}: launches (got, want) {bad}")
