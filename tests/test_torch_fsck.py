"""`python -m raft_stereo_tpu_torch fsck` and `check-report` against the JAX
package's `scripts/fsck_checkpoints.py` and `scripts/check_run_report.py`
on the same inputs: the same JSON verdicts (checkpoint roots), the same
output (run reports) and the same exit codes.

Checkpoint roots, each written by the port's step format (payload files,
run state, the integrity manifest last) and copied for each tool:
- "clean": steps 1 and 2, both committed;
- "torn": steps 1-2 committed, step 3's model.pth truncated after its
  commit and step 4 never committed (no manifest), plus a pre-existing
  quarantined dir;
- "legacy": steps 5 and 10 saved before manifests (no MANIFEST.json).
Each with and without `--quarantine`. Reports: what the trainer writes,
with and without the optional blocks, and mutated variants (a torn block,
a mistyped key, a missing key, an exit code that contradicts the stop
cause, a non-object), plus unreadable paths and `--selftest`.
"""

import importlib.util
import json
import os
import shutil

import pytest

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.utils import checkpoints as ck
from raft_stereo_tpu_torch.utils.run_report import build_run_report, write_run_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name: str):
    """One of the JAX package's scripts, imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_fsck():
    return jax_script("fsck_checkpoints")


@pytest.fixture(scope="module")
def jax_check():
    return jax_script("check_run_report")


def write_step(root: str, step: int, commit: bool = True) -> str:
    step_dir = os.path.join(root, str(step))
    os.makedirs(step_dir)
    with open(os.path.join(step_dir, ck.MODEL_NAME), "wb") as f:
        f.write(os.urandom(4096 + step))
    with open(os.path.join(step_dir, "optimizer.pt"), "wb") as f:
        f.write(os.urandom(1024))
    if commit:
        ck.commit_step_sidecars(step_dir, step, {"run_state_version": 1, "step": step})
    return step_dir


def make_root(base, kind: str) -> str:
    root = str(base / kind)
    os.makedirs(root)
    if kind == "clean":
        for step in (1, 2):
            write_step(root, step)
    elif kind == "torn":
        for step in (1, 2):
            write_step(root, step)
        torn = write_step(root, 3)
        with open(os.path.join(torn, ck.MODEL_NAME), "r+b") as f:
            f.truncate(100)
        write_step(root, 4, commit=False)
        os.makedirs(os.path.join(root, "7.corrupt-invalid"))
    else:
        for step in (5, 10):
            write_step(root, step, commit=False)
    return root


def relative(verdict: dict, root: str) -> dict:
    """The verdict with the root's path taken out (each tool ran on its
    own copy)."""
    return json.loads(json.dumps(verdict).replace(os.path.abspath(root), "<root>"))


@pytest.mark.parametrize("quarantine", [False, True], ids=["check", "quarantine"])
@pytest.mark.parametrize("kind", ["clean", "torn", "legacy"])
def test_fsck_matches_the_jax_script(kind, quarantine, jax_fsck, tmp_path, capsys):
    mine, theirs = make_root(tmp_path / "port", kind), str(tmp_path / "jax" / kind)
    shutil.copytree(mine, theirs)
    flags = ["--quarantine"] if quarantine else []
    code = cli.main(["fsck", mine, *flags])
    got = json.loads(capsys.readouterr().out)
    want_code = jax_fsck.main([theirs, *flags])
    want = json.loads(capsys.readouterr().out)
    assert code == want_code == (0 if kind == "clean" else 1)
    assert relative(got, mine) == relative(want, theirs)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    if kind == "torn":
        assert got["valid_steps"] == [1, 2] and got["invalid_steps"] == [3, 4] and got["latest_valid"] == 2
        assert ("3.corrupt-fsck" in os.listdir(mine)) == quarantine
    if kind == "legacy":
        assert got["latest_valid"] is None and got["invalid_steps"] == [5, 10]


def test_fsck_usage_errors_match(jax_fsck, tmp_path, capsys):
    missing = str(tmp_path / "nowhere")
    assert cli.main(["fsck", missing]) == jax_fsck.main([missing]) == 2
    err = capsys.readouterr().err
    assert err.count(f"not a directory: {missing}") == 2
    root = make_root(tmp_path, "torn")
    assert cli.main(["fsck", root, "--quiet"]) == jax_fsck.main([root, "--quiet"]) == 1
    assert capsys.readouterr().out == ""


def reports():
    """(name, payload) pairs: written by `build_run_report` (what the trainer writes), and
    mutated."""
    obs = {"enabled": True, "capacity": 256, "traces_total": 12, "spans_total": 48, "events_total": 3,
           "dropped_total": 0, "dumps_total": 1}
    out = [
        ("completed", build_run_report(stop_cause="completed", final_step=10)),
        ("resumed", build_run_report(stop_cause="completed", final_step=10, resumed_from_step=4, resume_count=1,
                                     fallback_steps_skipped=2)),
        ("preempted with observability", build_run_report(stop_cause="preempted", final_step=7, observability=obs)),
    ]
    torn = build_run_report(stop_cause="completed", final_step=10, observability=dict(obs))
    del torn["observability"]["spans_total"]
    wrong_exit = build_run_report(stop_cause="preempted", final_step=5)
    wrong_exit["exit_code"] = 0
    mistyped = build_run_report(stop_cause="completed", final_step=10)
    mistyped["final_step"] = "10"
    missing = build_run_report(stop_cause="completed", final_step=10)
    del missing["stop_cause"]
    out += [("torn block", torn), ("exit code contradicts the cause", wrong_exit), ("mistyped", mistyped),
            ("missing key", missing), ("non-object", ["not", "a", "dict"])]
    return out


@pytest.mark.parametrize("name,payload", reports(), ids=[n for n, _ in reports()])
def test_check_report_matches_the_jax_script(name, payload, jax_check, tmp_path, capsys):
    path = str(tmp_path / "run_report.json")
    if isinstance(payload, dict):
        write_run_report(payload, str(tmp_path))
    else:
        with open(path, "w") as f:
            json.dump(payload, f)
    code = cli.main(["check-report", path])
    got = capsys.readouterr()
    want_code = jax_check.main([path])
    want = capsys.readouterr()
    assert code == want_code == (0 if name in ("completed", "resumed", "preempted with observability") else 1)
    assert (got.out, got.err) == (want.out, want.err)


def test_check_report_selftest_and_io_errors_match(jax_check, tmp_path, capsys):
    assert cli.main(["check-report", "--selftest"]) == jax_check.main(["--selftest"]) == 0
    out = capsys.readouterr().out
    assert out.count("selftest: 17/17 cases passed") == 2
    missing = str(tmp_path / "none.json")
    assert cli.main(["check-report", missing]) == jax_check.main([missing]) == 2
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    assert cli.main(["check-report", str(garbage)]) == jax_check.main([str(garbage)]) == 2
    err = capsys.readouterr().err
    assert err.count(f"cannot read {missing}") == 2 and err.count(f"cannot read {garbage}") == 2
