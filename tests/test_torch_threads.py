"""The suite's thread policy (the repository root's ``conftest.py``): one
intra-op torch thread in the test process, in a rank that
``torch.multiprocessing`` spawns and in a command-line subprocess."""

import subprocess
import sys

import torch
import torch.multiprocessing as mp


def _child_threads(rank, out_file):
    with open(out_file, "w") as f:
        f.write(str(torch.get_num_threads()))


def test_the_test_process_runs_one_thread():
    assert torch.get_num_threads() == 1


def test_a_spawned_rank_runs_one_thread(tmp_path):
    out_file = str(tmp_path / "threads.txt")
    mp.spawn(_child_threads, args=(out_file,), nprocs=1, join=True)
    with open(out_file) as f:
        assert f.read() == "1"


def test_a_subprocess_runs_one_thread():
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"
