"""The port's eval scripts against the JAX package's, and the smoke's T&T
flags against the script's ``Family`` row.

Each script runs under bash with a ``python`` on the PATH that records its
arguments (and the scene list that ``tt_eval.sh`` hands over through a
process substitution) instead of running the CLI, so the invocations are
the ones bash builds from the per-scene tables.
"""

from __future__ import annotations

import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from cds_mvsnet_tpu.cli.test_cli import build_parser as jax_parser
from cds_mvsnet_tpu_torch.cli.test_cli import build_parser as port_parser

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

JAX_MODULE, PORT_MODULE = "cds_mvsnet_tpu.cli.test_cli", "cds_mvsnet_tpu_torch.cli.test_cli"
TT_SCENES = ["Family", "Francis", "Horse", "Lighthouse", "M60", "Panther", "Playground", "Train"]
# where the recorder writes, in the order of the calls
RECORDER = f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
if "--testlist" in args:
    i = args.index("--testlist") + 1
    if args[i].startswith("/dev/fd/"):
        args[i] = "<(" + open(args[i]).read().strip() + ")"
with open(os.environ["RECORD"], "a") as f:
    f.write(json.dumps(args) + "\\n")
"""


def invocations(script: Path, tmp_path: Path) -> list[list[str]]:
    """The argument lists of every ``python`` call of ``script``."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    shim = bindir / "python"
    shim.write_text(RECORDER)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    record = tmp_path / f"{script.parent.parent.name}_{script.name}.jsonl"
    env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}", "RECORD": str(record)}
    out = subprocess.run(["bash", str(script), "DATA", "CKPT.pth", "OUT"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return [json.loads(line) for line in record.read_text().splitlines()]


@pytest.mark.parametrize("name", ["dtu_eval.sh", "tt_eval.sh"])
def test_port_script_is_the_jax_script_on_the_port(name):
    """The same text apart from the module it runs and the header comment
    that names the JAX original."""
    jax_text = (REPO / "scripts" / name).read_text()
    port_text = (REPO / "cds_mvsnet_tpu_torch" / "scripts" / name).read_text()
    port_lines = port_text.splitlines(keepends=True)
    header = port_lines[1:3]
    assert all(line.startswith("# ") for line in header) and f"scripts/{name}" in header[0]
    body = port_lines[0] + "".join(port_lines[3:])
    assert PORT_MODULE in body and JAX_MODULE + " " not in body
    assert body.replace(PORT_MODULE, JAX_MODULE) == jax_text
    assert os.stat(REPO / "cds_mvsnet_tpu_torch" / "scripts" / name).st_mode & stat.S_IXUSR


@pytest.mark.parametrize("name,calls", [("dtu_eval.sh", 1), ("tt_eval.sh", len(TT_SCENES))])
def test_every_invocation_parses_alike_under_both_clis(name, calls, tmp_path):
    """Each call of the port's script runs the port's CLI with the JAX
    script's arguments, which both parsers read to the same options (the
    DTU line and the 8 T&T scene rows)."""
    jax_calls = invocations(REPO / "scripts" / name, tmp_path)
    port_calls = invocations(REPO / "cds_mvsnet_tpu_torch" / "scripts" / name, tmp_path)
    assert len(jax_calls) == len(port_calls) == calls
    for want, got in zip(jax_calls, port_calls):
        assert want[:2] == ["-m", JAX_MODULE] and got[:2] == ["-m", PORT_MODULE]
        assert got[2:] == want[2:]
        assert vars(port_parser().parse_args(got[2:])) == vars(jax_parser().parse_args(want[2:]))
    if name == "tt_eval.sh":
        scenes = [c[c.index("--testlist") + 1] for c in port_calls]
        assert scenes == [f"<({s})" for s in TT_SCENES]


def test_smoke_tt_flags_are_the_family_row(tmp_path):
    """chip_smoke.py's T&T phase runs the ``Family`` row of the port's
    tt_eval.sh: its flags are the row's, less the paths."""
    calls = invocations(REPO / "cds_mvsnet_tpu_torch" / "scripts" / "tt_eval.sh", tmp_path)
    family = next(c for c in calls if "<(Family)" in c)[2:]
    flags, skip = [], False
    for arg in family:
        if skip:
            skip = False
        elif arg in ("--testpath", "--testlist", "--resume", "--outdir"):
            skip = True
        else:
            flags.append(arg)
    assert chip_smoke.TT_FLAGS == flags
    args = port_parser().parse_args(["--testpath", "D", "--resume", "C", *chip_smoke.TT_FLAGS])
    assert (args.num_view, args.numdepth, args.max_h, args.max_w, args.no_refinement) == (
        chip_smoke.TT_SOURCES + 1, 256, chip_smoke.TT_H, chip_smoke.TT_W, True)
