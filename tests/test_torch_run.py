"""The launcher of horovod_tpu_torch (``horovod_tpu_torch/run/``) against
the JAX package's (``horovod_tpu/run/``), case for case with
``tests/test_run.py`` where a case has meaning in the port: host parsing,
LSF/SLURM, slot allocation and identity, flags and the config file to
environment (the pure functions' outputs equal the JAX package's for the
same inputs), the local and ssh commands, the process-tree kill, the
job's teardown on a failure, the programmatic ``run()`` on two processes
(a gloo world formed through ``env://``) and the CLI end to end with its
exit codes — 75 for a preempted job, also when the launcher itself gets
the SIGTERM. Plus ``basics.init``'s refusal of more local slots than
GPUs."""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from unittest import mock

import pytest

from horovod_tpu.run import config_parser as jcp, hosts as jhosts
from horovod_tpu.run import runner as jrunner
from horovod_tpu_torch.run import (
    config_parser, env_util, hosts, runner, safe_exec,
)

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT, **kw)
    env.pop("HOROVOD_CHAOS", None)
    return env


def _infos(infos):
    return [(h.hostname, h.slots) for h in infos]


# ---------------------------------------------------------------- hosts


@pytest.mark.parametrize("spec", ["h1:4,h2:2,h3", "localhost", "a:1, b:3",
                                  "node-1.example.com:8,10.0.0.2:2"])
def test_parse_hosts_matches_jax(spec):
    assert _infos(hosts.parse_hosts(spec)) == _infos(jhosts.parse_hosts(spec))


def test_parse_hosts_rejects_a_bad_spec():
    with pytest.raises(ValueError, match="bad host spec"):
        hosts.parse_hosts("bad host!")


def test_parse_hostfile_matches_jax(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("h1 slots=4\n# comment\nh2 slots=2\nh3\n")
    assert _infos(hosts.parse_hostfile(str(f))) == [
        ("h1", 4), ("h2", 2), ("h3", 1)]
    assert _infos(hosts.parse_hostfile(str(f))) == _infos(
        jhosts.parse_hostfile(str(f)))


@pytest.mark.parametrize("spec,np", [("h1:2,h2:2", 4), ("h1:4,h2:2", 5),
                                     ("h1:1,h2:1,h3:1", 2), ("localhost:4", 4),
                                     ("a:3,b:1,c:2", 6)])
def test_allocate_and_slot_env_match_jax(spec, np):
    import dataclasses

    got = hosts.allocate(hosts.parse_hosts(spec), np)
    want = jhosts.allocate(jhosts.parse_hosts(spec), np)
    assert [dataclasses.asdict(s) for s in got] == [
        dataclasses.asdict(s) for s in want]
    assert [hosts.slot_env(s) for s in got] == [
        jhosts.slot_env(s) for s in want]


def test_allocate_coordinates():
    slots = hosts.allocate(hosts.parse_hosts("h1:2,h2:2"), 4)
    assert [s.local_rank for s in slots] == [0, 1, 0, 1]
    assert [s.cross_rank for s in slots] == [0, 0, 1, 1]
    assert all(s.local_size == 2 and s.cross_size == 2 for s in slots)


def test_allocate_oversubscribe_rejected():
    with pytest.raises(ValueError, match="exceeds available slots"):
        hosts.allocate(hosts.parse_hosts("h1:2"), 3)


def _lsf_file(tmp_path):
    hf = tmp_path / "lsb_hosts"
    hf.write_text("node1\nnode1\nnode2\nnode2\n")
    return {"LSB_DJOB_HOSTFILE": str(hf)}


SCHEDULER_ENVS = {
    "lsf_hostfile": _lsf_file,
    "lsb_hosts": lambda p: {"LSB_HOSTS": "a a a b"},
    "slurm_ntasks": lambda p: {"SLURM_JOB_NODELIST": "gpu[01-03],cpu7",
                               "SLURM_NTASKS_PER_NODE": "4"},
    "slurm_tasks_per_node": lambda p: {"SLURM_JOB_NODELIST": "n[1-3],m5",
                                       "SLURM_TASKS_PER_NODE": "2(x3),1"},
    "lsf_unreadable": lambda p: {
        "LSB_DJOB_HOSTFILE": str(p / "does_not_exist"), "LSB_HOSTS": "x x y"},
    "empty": lambda p: {},
}


@pytest.mark.parametrize("case", sorted(SCHEDULER_ENVS))
def test_hosts_from_scheduler_env_matches_jax(case, tmp_path):
    env = SCHEDULER_ENVS[case](tmp_path)
    got = hosts.hosts_from_scheduler_env(env)
    want = jhosts.hosts_from_scheduler_env(env)
    if want is None:
        assert got is None
    else:
        assert _infos(got) == _infos(want)
    if case == "slurm_tasks_per_node":
        assert _infos(got) == [("n1", 2), ("n2", 2), ("n3", 2), ("m5", 1)]


# ---------------------------------------------------------------- args/env


ARGVS = {
    "knobs": ["-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms",
              "3.5", "--cache-capacity", "2048", "--timeline-filename",
              "/tmp/t.json", "--timeline-mark-cycles",
              "--stall-check-warning-time-seconds", "120",
              "--stall-check-shutdown-time-seconds", "240", "--autotune",
              "--autotune-log-file", "/tmp/a.csv", "--log-level", "INFO",
              "--native-core", "python", "train.py"],
    "hierarchical": ["-np", "1", "--hierarchical-allreduce",
                     "--no-hierarchical-allgather", "x"],
    "unset": ["-np", "1", "x"],
    "no_stall_check": ["-np", "1", "--no-stall-check", "x"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_args_to_env_matches_jax(case):
    env, jenv = {}, {}
    args = runner.parse_args(ARGVS[case])
    config_parser.set_env_from_args(env, args)
    jcp.set_env_from_args(jenv, jrunner.parse_args(ARGVS[case]))
    assert env == jenv
    if case == "knobs":
        assert env["HOROVOD_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)
        assert env["HOROVOD_NATIVE_CORE"] == "1"
        assert args.command == ["python", "train.py"]
    if case == "unset":
        assert "HOROVOD_HIERARCHICAL_ALLREDUCE" not in env
    if case == "no_stall_check":
        assert env["HOROVOD_STALL_CHECK_DISABLE"] == "1"


def test_hierarchical_flags_are_exclusive():
    with pytest.raises(SystemExit):
        runner.parse_args(["-np", "1", "--hierarchical-allreduce",
                           "--no-hierarchical-allreduce", "x"])


def test_validate_args():
    with pytest.raises(ValueError, match="cycle-time-ms"):
        runner.parse_args(["-np", "1", "--cycle-time-ms", "0", "x"])


CONFIG_YAML = textwrap.dedent(
    """
    fusion_threshold_mb: 16
    cycle_time_ms: 2.5
    cache_capacity: 512
    timeline:
        filename: /tmp/conf_timeline.json
        mark_cycles: true
    stall_check:
        warning_time_seconds: 99
    autotune:
        enable: true
        log_file: /tmp/conf_autotune.csv
    library_options:
        log_level: DEBUG
    """
)


@pytest.mark.parametrize("extra", [[], ["--cycle-time-ms", "7"]],
                         ids=["config", "cli_overrides_config"])
def test_config_file_matches_jax(tmp_path, extra):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG_YAML)
    argv = ["-np", "1", "--config-file", str(cfg), *extra, "x"]
    args, jargs = runner.parse_args(argv), jrunner.parse_args(argv)
    env, jenv = {}, {}
    config_parser.set_env_from_args(env, args)
    jcp.set_env_from_args(jenv, jargs)
    assert env == jenv
    assert args.fusion_threshold_mb == 16
    assert args.cycle_time_ms == (7 if extra else 2.5)


def test_config_unknown_key_rejected(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("nonsense_key: 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        runner.parse_args(["-np", "1", "--config-file", str(cfg), "x"])


# ---------------------------------------------------------------- commands


def test_worker_env_carries_identity_store_and_core():
    slot = hosts.allocate(hosts.parse_hosts("localhost:2"), 2)[1]
    env = runner.worker_env(slot, {"A": "1"}, store_addr="127.0.0.1",
                            store_port=1234, core_port=5678)
    assert env["A"] == "1"
    assert {k: env[k] for k in hosts.slot_env(slot)} == hosts.slot_env(slot)
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("127.0.0.1", "1234")
    assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"
    assert (env["HVD_CORE_COORD_ADDR"], env["HVD_CORE_COORD_PORT"]) == (
        "127.0.0.1", "5678")
    assert "HVD_CORE_COORD_PORT" not in runner.worker_env(
        slot, {}, store_addr="h", store_port=1)


def test_build_command_local():
    slot = hosts.allocate(hosts.parse_hosts("localhost:2"), 2)[1]
    argv, env = runner.build_command_for_slot(
        slot, ["python", "train.py"], {"A": "1"}, "127.0.0.1", 1234, 5678)
    assert argv == ["python", "train.py"]
    assert env["MASTER_PORT"] == "1234"
    assert env["HVD_CORE_COORD_PORT"] == "5678"
    assert env["HOROVOD_RANK"] == "1"
    assert "HVD_COORDINATOR_ADDR" not in env


def test_build_command_remote_ssh_exports_the_ports_variables():
    slot = hosts.allocate(hosts.parse_hosts("far-host:1"), 1)[0]
    argv, _ = runner.build_command_for_slot(
        slot, ["python", "train.py"],
        {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "x", "NCCL_DEBUG": "INFO"},
        "far-host", 1234, 5678, ssh_port=2222, store_addr="10.0.0.1")
    assert argv[0] == "ssh" and "-p" in argv and "2222" in argv
    assert argv[-2] == "far-host"
    remote = argv[-1]
    for part in ("HOROVOD_RANK=0", "HVD_CORE_COORD_PORT=5678",
                 "HVD_CORE_COORD_ADDR=far-host", "MASTER_ADDR=10.0.0.1",
                 "MASTER_PORT=1234", "TORCHELASTIC_USE_AGENT_STORE=True",
                 "NCCL_DEBUG=INFO", "python train.py"):
        assert part in remote, part
    assert "JAX_" not in remote and "XLA_" not in remote


def _fake_execute(behaviour, seen):
    def execute(argv, env=None, stdout_handler=None, stderr_handler=None,
                event=None, shell=False, signal_event=None):
        rank = int(env["HOROVOD_RANK"])
        seen.append((rank, env["MASTER_PORT"]))
        return behaviour(rank, event, signal_event, len(seen))
    return execute


def test_launch_job_mocked_failure_kills_job():
    slots = hosts.allocate(hosts.parse_hosts("localhost:2"), 2)
    seen = []

    def behaviour(rank, event, signal_event, k):
        if rank == 0:
            return 3
        assert event.wait(10), "rank 1 was never told to stop"
        return -signal.SIGTERM

    with mock.patch.object(runner.safe_exec, "execute",
                           _fake_execute(behaviour, seen)):
        codes = runner.launch_job(slots, ["python", "train.py"], {})
    assert sorted(r for r, _ in seen) == [0, 1]
    assert codes == [3, -signal.SIGTERM]


def test_launch_job_restart_meets_a_fresh_world_store():
    """A slot restarted after a preemption (exit 75) forms its world at a
    new store: attempt k of every slot meets at the k-th one."""
    slots = hosts.allocate(hosts.parse_hosts("localhost:2"), 2)
    seen = []

    def behaviour(rank, event, signal_event, k):
        return 75 if sum(r == rank for r, _ in seen) == 1 else 0

    with mock.patch.dict(os.environ,
                         {"HOROVOD_RETRY_WORKER_RESTART_BASE_DELAY": "0.01"}), \
            mock.patch.object(runner.safe_exec, "execute",
                              _fake_execute(behaviour, seen)):
        codes = runner.launch_job(slots, ["x"], {}, max_restarts=1)
    assert codes == [0, 0]
    ports = {r: [p for rr, p in seen if rr == r] for r in (0, 1)}
    assert ports[0][0] == ports[1][0] and ports[0][1] == ports[1][1]
    assert ports[0][0] != ports[0][1]


def test_launch_job_forwards_a_preemption_to_every_worker(tmp_path):
    """``preempt`` set: each worker's process group gets one SIGTERM; the
    workers exit 75 on their own (no kill), and every code is 75."""
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent("""
        import os, signal, sys, time
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(75))
        open(os.path.join(sys.argv[1], os.environ["HOROVOD_RANK"]), "w")
        time.sleep(60)
        sys.exit(1)
    """))
    slots = hosts.allocate(hosts.parse_hosts("localhost:2"), 2)
    preempt = threading.Event()

    def trigger():
        t0 = time.monotonic()
        while len(os.listdir(tmp_path)) < 3 and time.monotonic() - t0 < 60:
            time.sleep(0.02)
        preempt.set()

    threading.Thread(target=trigger, daemon=True).start()
    t0 = time.monotonic()
    codes = runner.launch_job(slots, [sys.executable, str(script),
                                      str(tmp_path)], _env(),
                              preempt=preempt, timeout_s=60)
    assert codes == [75, 75]
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------- safe_exec


def test_safe_exec_basic():
    assert safe_exec.execute([sys.executable, "-c", "print('hi')"]) == 0


def test_safe_exec_kills_process_tree():
    script = (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(60)'])\n"
        "print('child pid', p.pid, flush=True)\n"
        "time.sleep(60)\n"
    )
    lines, event = [], threading.Event()

    def on_out(line):
        lines.append(line)
        if line.startswith("child pid"):
            event.set()

    t0 = time.monotonic()
    rc = safe_exec.execute([sys.executable, "-u", "-c", script],
                           stdout_handler=on_out, event=event)
    assert rc == -signal.SIGTERM and time.monotonic() - t0 < 30
    pid = int(next(ln for ln in lines if ln.startswith("child pid")).split()[-1])
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        os.kill(pid, signal.SIGKILL)
        pytest.fail("grandchild survived tree kill")


def test_safe_exec_signal_event_sends_one_sigterm_and_no_kill():
    script = (
        "import signal, sys, time\n"
        "hits = []\n"
        "signal.signal(signal.SIGTERM, lambda *_: hits.append(1))\n"
        "print('ready', flush=True)\n"
        "t0 = time.time()\n"
        "while not hits and time.time() - t0 < 30: time.sleep(0.01)\n"
        "time.sleep(0.5)\n"
        "sys.exit(70 + len(hits))\n"
    )
    sig = threading.Event()
    rc = safe_exec.execute(
        [sys.executable, "-u", "-c", script],
        stdout_handler=lambda ln: sig.set() if ln.startswith("ready") else None,
        signal_event=sig)
    assert rc == 71


def test_install_sigterm_exit_runs_finalizers(tmp_path):
    mark = tmp_path / "finally"
    code = (
        "import os, signal, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from horovod_tpu_torch.run.env_util import install_sigterm_exit\n"
        "install_sigterm_exit()\n"
        "try:\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    import time; time.sleep(10)\n"
        "finally:\n"
        f"    open({str(mark)!r}, 'w').close()\n"
    )
    r = subprocess.run([sys.executable, "-c", code], timeout=60)
    assert r.returncode == 143 and mark.exists()
    assert not hasattr(env_util, "scrub_plugin_hooks")


# ---------------------------------------------------------------- end-to-end


def test_programmatic_run_two_processes_form_a_gloo_world():
    # nested: cloudpickle ships it by value (the worker cannot import
    # this test module)
    def gloo_worker(x):
        import torch

        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        try:
            t = hvd.allreduce(torch.full((3,), float(hvd.rank() + 1)),
                              hvd.Sum)
            return {"rank": hvd.rank(), "size": hvd.size(),
                    "local_rank": hvd.local_rank(),
                    "local_size": hvd.local_size(), "sum": t.tolist(),
                    "x2": x * 2}
        finally:
            hvd.shutdown()

    results = runner.run(gloo_worker, args=(21,), np=2, timeout_s=120,
                         env=_env())
    assert results == [
        {"rank": r, "size": 2, "local_rank": r, "local_size": 2,
         "sum": [3.0, 3.0, 3.0], "x2": 42} for r in (0, 1)]


def test_programmatic_run_propagates_worker_error():
    def boom():
        raise RuntimeError("worker exploded")

    with pytest.raises(RuntimeError, match="worker exploded"):
        runner.run(boom, np=1, timeout_s=120, env=_env())


def _cli(argv, **kw):
    return subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                           *argv], env=_env(), cwd=ROOT, capture_output=True,
                          text=True, timeout=120, **kw)


def test_cli_end_to_end(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(
        "import os\n"
        "print('R', os.environ['HOROVOD_RANK'], 'of',"
        " os.environ['HOROVOD_SIZE'], os.environ['MASTER_ADDR'],"
        " os.environ['HVD_RUN_KV_ADDR'] == os.environ['MASTER_ADDR'])\n")
    out_dir = tmp_path / "logs"
    r = _cli(["-np", "2", "--output-filename", str(out_dir),
              sys.executable, str(script)])
    assert r.returncode == 0, r.stderr
    assert (out_dir / "rank.0.out").read_text().strip() == \
        "R 0 of 2 127.0.0.1 True"
    assert (out_dir / "rank.1.out").read_text().strip() == \
        "R 1 of 2 127.0.0.1 True"


@pytest.mark.parametrize("code,want", [(7, 1), (75, 75)])
def test_cli_exit_codes(tmp_path, code, want):
    script = tmp_path / "bad.py"
    script.write_text(f"import sys; sys.exit({code})\n")
    assert runner.run_commandline(
        ["-np", "1", sys.executable, str(script)]) == want


def test_cli_sigterm_to_the_launcher_exits_75(tmp_path):
    """A SIGTERM to ``python -m horovod_tpu_torch.run`` reaches both
    workers, which drain and exit 75; so does the launcher."""
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent(f"""
        import os, signal, sys, time
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(75))
        open(os.path.join({str(tmp_path)!r}, "up" + os.environ["HOROVOD_RANK"]),
             "w").close()
        time.sleep(60)
        sys.exit(1)
    """))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--kv-standbys", "1", sys.executable, str(script)],
        env=_env(), cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        t0 = time.monotonic()
        while not all((tmp_path / f"up{r}").exists() for r in (0, 1)):
            assert time.monotonic() - t0 < 60 and proc.poll() is None
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_check_build_reports_the_port():
    import torch.distributed as dist

    r = _cli(["--check-build"])
    assert r.returncode == 0
    out = r.stdout
    assert "horovod_tpu_torch v" in out
    assert "[X] PyTorch" in out and "[X] Gloo" in out
    assert f"[{'X' if dist.is_nccl_available() else ' '}] NCCL" in out
    assert "[ ] MPI" in out and "nvcc found" in out and "kernels built" in out


def test_mpi_flag_rejected():
    r = _cli(["--mpi", "-np", "1", "--", "python", "x.py"])
    assert r.returncode == 2 and "no MPI by design" in r.stderr


def test_gloo_flag_accepted():
    args = runner.parse_args(["--gloo", "-np", "2", "--", "python", "x.py"])
    assert args.use_gloo is True and args.np == 2


def test_bin_script_prints_the_version():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bin",
                                                     "hvdrun_torch"),
                        "--version"], capture_output=True, text=True,
                       timeout=120, env=_env())
    import horovod_tpu_torch

    assert r.returncode == 0 and r.stdout.strip() == horovod_tpu_torch.__version__


# ---------------------------------------------------------------- basics


@pytest.mark.parametrize("local_size,gpus", [(4, 2), (2, 1)])
def test_init_refuses_more_local_slots_than_gpus(monkeypatch, local_size,
                                                 gpus):
    import torch

    from horovod_tpu_torch import basics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", str(local_size))
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "0")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_SIZE", str(local_size))
    with pytest.raises(RuntimeError) as e:
        basics.init()
    msg = str(e.value)
    assert f"{local_size} local slots" in msg and f"{gpus} visible GPUs" in msg
    assert not basics.is_initialized()
