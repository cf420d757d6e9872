"""True multi-process training: 2 jax.distributed processes over a global
mesh (scripts/multihost_demo.py run as subprocesses). Validates the
make_array_from_process_local_data path, cross-host collectives inside the
jitted epoch, and cross-host metric combining."""

import os
import subprocess
import sys


def test_two_process_training():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + (os.getpid() % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    # both processes converge to the same global loss
    lines = [l for l in proc.stdout.splitlines() if "losses" in l]
    assert len(lines) == 2
    assert lines[0].split("losses")[1].split("recall")[0] == lines[
        1
    ].split("losses")[1].split("recall")[0]


def test_two_process_training_full_variant():
    """Adam slots, user-attention pooling, tile sampler, and cached pools
    all sharded across two real processes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + ((os.getpid() + 1) % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
            "--variant",
            "full",
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout


def test_two_process_fused_epochs():
    """The multi-host fused multi-epoch programs (per-epoch-shuffled
    stream + fixed stream) reproduce sequential per-epoch dispatches
    exactly across 2 real processes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + ((os.getpid() + 3) % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
            "--variant",
            "fused",
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    assert proc.stdout.count("fused==sequential") == 2


def test_two_process_subepoch_partitioning():
    """Sub-epoch item partitioning across 2 real processes: same-seeded
    host RNG partitions agree cross-host and the trajectory lands near a
    1-process run."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + ((os.getpid() + 5) % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
            "--variant",
            "subepoch",
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    assert "subepoch 2-proc vs 1-proc" in proc.stdout


def test_two_process_checkpoint_resume():
    """Sharded Orbax save/restore across 2 real processes: the resumed run
    reproduces the uninterrupted run's losses (failure-recovery path)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + ((os.getpid() + 2) % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
            "--variant",
            "checkpoint",
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    assert proc.stdout.count("checkpoint-resume losses match") == 2


def test_two_process_visit_order_user():
    """Round 5: cfg.visit_order='user' across 2 real processes — each
    process sorts its own scrambled user-range shard, reproduces the
    externally pre-sorted stream exactly, and the multi-host dedup maps
    engage."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + ((os.getpid() + 9) % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
            "--variant",
            "visit",
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    assert proc.stdout.count("visit_order ok") == 2


def test_two_process_attention_dedup():
    """Round 5: the multi-host ATTENTION history-gather dedup (uniq_first
    offset into the global batch axis) across 2 real processes — engaged
    maps reproduce the maps-off run for user_attention and
    self_attention on the parse-order stream."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = 40000 + ((os.getpid() + 3) % 20000)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "scripts", "multihost_demo.py"),
            "--procs",
            "2",
            "--port",
            str(port),
            "--variant",
            "accl",
        ],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    assert proc.stdout.count("accl dedup ok") == 2
