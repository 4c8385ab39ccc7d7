"""The port's GIF CLI (``diffdrr_tpu_torch.experiments.gif``) on the CPU.

``main(argv)`` with ``--cpu`` on a 3-row trace writes a GIF of 3 frames and
returns its path; a CSV without the pose columns raises the JAX CLI's
message (``experiments/gif.py``, run through ``click.testing.CliRunner``).
The flags and defaults are the JAX CLI's.
"""

import csv
import importlib.util
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from click.testing import CliRunner

from diffdrr_tpu_torch.experiments import gif

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--volume-size", "32", "--height", "16"]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_gif_cli", ROOT / "experiments" / "gif.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def test_main_writes_one_frame_per_row(tmp_path, capsys):
    rows = [[0.02 * k, np.pi / 2, 0.0, 1.0 * k, 850.0, -0.5 * k] for k in range(3)]
    trace = _write(tmp_path / "trace.csv", ["iter", *gif.POSE_COLUMNS],
                   [[k, *r] for k, r in enumerate(rows)])
    out = gif.main(["--cpu", *SMALL, str(trace), str(tmp_path / "run.gif")])
    assert out == tmp_path / "run.gif" and out.stat().st_size > 1000
    assert len(imageio.mimread(out)) == 3
    assert f"wrote {out}" in capsys.readouterr().out
    assert [[float(r[c]) for c in gif.POSE_COLUMNS] for r in gif.read_trace(trace)] == rows


def test_missing_pose_columns_raise_the_jax_message(tmp_path):
    trace = _write(tmp_path / "scores.csv", ["iter", "score", "r1"], [[0, 0.5, 0.1]])
    res = CliRunner().invoke(_jax_cli().main, ["--cpu", *SMALL, str(trace),
                                               str(tmp_path / "jax.gif")])
    assert res.exit_code == 1
    msg = res.output.strip().removeprefix("Error: ")
    assert "lacks pose columns" in msg
    with pytest.raises(ValueError) as err:
        gif.main(["--cpu", *SMALL, str(trace), str(tmp_path / "port.gif")])
    assert str(err.value) == msg
    assert not (tmp_path / "port.gif").exists()


def test_flags_and_defaults_match_the_jax_cli():
    params = {p.name: p for p in _jax_cli().main.params}
    args = gif.parse_args(["a.csv", "b.gif"])
    assert (args.csv_path, args.out_path) == ("a.csv", "b.gif")
    for name in ("cpu", "height", "volume_size"):
        assert getattr(args, name) == params[name].default, name
    assert gif.parse_args(["--cpu", "a", "b"]).cpu is True
