"""Set-up: from the start of ``run.py`` to the first timed step (imports, the
CT, the program's objects, its build and first calls, the first steps)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
