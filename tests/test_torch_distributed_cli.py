"""`train` across two ranks on the CPU: the command line a user runs under
torchrun, its ranks started directly with torchrun's environment (so each
rank's own exit code is seen; torchrun's agent would replace it with its
own) and joined over gloo.

SIGTERM to rank 1 alone stops both ranks at one step with exit 13, as the
JAX package's two-process fault test does (tests/test_distributed.py),
under dp and under fsdp, with rank 0 validating while rank 1 waits.
"""

import json
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from raft_stereo_tpu_torch.data import trees
from raft_stereo_tpu_torch.utils import checkpoints as ck
from torch_parity import free_port, rank_env, torch_single_thread  # noqa: F401 (autouse fixture)

TINY = ["--hidden_dims", "16", "16", "16", "--corr_levels", "2", "--corr_radius", "2"]


@pytest.mark.parametrize("preset", ["dp", "fsdp"])
def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path, preset):
    """`train` as two ranks over a FlyingThings3D tree, validating every 2
    steps: SIGTERM to rank 1 alone after its second step. Both ranks stop
    at the same step and exit 13 (each rank's own code: the ranks are
    started directly, without torchrun's agent), rank 0's report names the
    peer's stop and rank 1's the signal, and that step alone is committed,
    with both ranks' run states; rank 0 alone validated and wrote
    metrics."""
    trees.write_sceneflow(str(tmp_path / "datasets"), np.random.default_rng(4), 8, 2, h=60, w=88, max_disp=8.0)
    argv = [sys.executable, "-m", "raft_stereo_tpu_torch", "train", "--device", "cpu", *TINY, "--batch_size", "2",
            "--image_size", "48", "64", "--train_iters", "2", "--num_steps", "40", "--root_dataset", "datasets",
            "--num_workers", "1", "--name", "pod", "--sharding_rules", preset, "--step_timeout_s", "120",
            "--valid_datasets", "things", "--validate_every", "2", "--valid_iters", "2"]
    port = free_port()
    procs = [subprocess.Popen(argv, env=rank_env(r, 2, port), cwd=tmp_path, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = ["", ""]

    def pump(i):
        for line in procs[i].stderr:
            logs[i] += line

    readers = [threading.Thread(target=pump, args=(i,), daemon=True) for i in range(2)]
    for t in readers:
        t.start()
    try:
        deadline = time.time() + 240
        while not re.search(r" step 2: ", logs[1]):
            assert procs[1].poll() is None and time.time() < deadline, logs[1][-3000:]
            time.sleep(0.02)
        procs[1].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for t in readers:
            t.join(timeout=10)
    assert codes == [13, 13], (codes, logs[0][-3000:], logs[1][-3000:])
    reports = [json.load(open(tmp_path / "runs" / name)) for name in ("run_report.json", "run_report.p1.json")]
    assert [r["process_index"] for r in reports] == [0, 1] and {r["process_count"] for r in reports} == {2}
    assert all(r["stop_cause"] == "preempted" and r["coord_syncs"] > 0 for r in reports)
    assert (reports[0]["preempt_signal"], reports[1]["preempt_signal"]) == ("peer", "SIGTERM")
    stop = reports[0]["final_step"]
    assert stop >= 2 and reports[1]["final_step"] == stop
    assert reports[0]["last_good_step"] == reports[1]["last_good_step"] == stop
    root = tmp_path / "checkpoints" / "pod"
    assert ck.list_checkpoint_steps(str(root)) == [stop]
    assert ck.validate_checkpoint(str(root / str(stop))) == []
    assert (root / str(stop) / "run_state.p1.json").exists()
    # Rank 0 validated (under fsdp on a gathered copy) while rank 1 waited;
    # only rank 0 writes metrics.
    metrics = [json.loads(line) for line in open(tmp_path / "runs" / "metrics.jsonl")]
    assert any("things-epe" in m for m in metrics)
