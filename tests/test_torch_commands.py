"""The port's own commands: the ``pcs-torch-*`` console scripts, the
loopback-cluster launcher, the camera-host scripts and the registration
shims.

Every ``pcs-X`` of pyproject.toml has a ``pcs-torch-X`` that names the
port's module of the same path, imports where JAX cannot be imported, and
parses the JAX command's flags. ``scripts/local_cluster_torch.py`` stitches
on the CPU under ``PCS_PLATFORM=cpu`` with JAX blocked in every process it
starts, and fails when a server does not come up. The camera-host scripts
start and kill the port's server (``ssh`` replaced by a local stand-in),
and the kill pattern spares the JAX package's server. Each test has its
own time limit, and so has every process it starts.
"""
import argparse
import importlib
import json
import os
import re
import socket
import subprocess
import sys
import time
import tomllib

import pytest

from test_torch_runtime import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
CHILD_TIMEOUT = 120
BLOCK_JAX = ("jax", "jaxlib", "flax", "pointcloud_stitching_tpu", "cv2")


def _scripts() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


JAX_COMMANDS = sorted(k for k, v in _scripts().items()
                      if v.startswith("pointcloud_stitching_tpu."))


def _parser_of(target: str) -> argparse.ArgumentParser:
    """The parser a command's main builds, caught where it parses."""
    module, func = target.split(":")
    main = getattr(importlib.import_module(module), func)
    caught = []

    def grab(self, args=None, namespace=None):
        caught.append(self)
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main(["--help"])
    finally:
        argparse.ArgumentParser.parse_args = real
    assert len(caught) == 1, target
    return caught[0]


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings) or (a.dest,): (
        a.dest, a.default, a.choices, a.nargs, type(a).__name__,
        getattr(a.type, "__name__", a.type), a.required)
        for a in parser._actions}


def test_every_jax_command_is_listed():
    assert len(JAX_COMMANDS) == 10 and "pcs-stitch" in JAX_COMMANDS


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_each_command_has_a_torch_command_with_its_flags(command):
    scripts = _scripts()
    want = scripts[command]
    torch_cmd = command.replace("pcs-", "pcs-torch-", 1)
    assert torch_cmd in scripts, f"no {torch_cmd} in pyproject.toml"
    got = scripts[torch_cmd]
    assert got == want.replace("pointcloud_stitching_tpu.",
                               "pointcloud_stitching_tpu_torch.", 1)
    assert got.endswith(":main")
    jax_flags, port_flags = _flags(_parser_of(want)), _flags(_parser_of(got))
    assert len(jax_flags) > 3
    assert port_flags == jax_flags


def _run(args, env=None, timeout=CHILD_TIMEOUT, **kw):
    return subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=timeout, **kw)


@time_limit(90)
def test_the_port_commands_import_with_jax_blocked():
    """Every pcs-torch-* target, the launcher and the registration shims
    load in a process where JAX and the JAX package cannot be imported."""
    targets = [v for k, v in _scripts().items() if k.startswith("pcs-torch-")]
    assert len(targets) == 10
    code = f"""
import importlib, runpy, sys
for name in {BLOCK_JAX!r}:
    sys.modules[name] = None        # any import of these raises ImportError
for target in {targets!r}:
    module, func = target.split(":")
    assert callable(getattr(importlib.import_module(module), func)), target
for path in ("registration/register_cli_torch.py",
             "registration/pick_cli_torch.py",
             "registration/graph_cli_torch.py",
             "scripts/local_cluster_torch.py"):
    assert callable(runpy.run_path(path, run_name="loaded")["main"]), path
print("loaded", len({targets!r}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run([sys.executable, "-c", code], env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "10"


def _free_base_port(n: int) -> int:
    """A base port with n free ports above it (checked by binding each)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65536:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no run of free ports")


@pytest.fixture
def no_jax_env(tmp_path):
    """The environment for the launcher: PCS_PLATFORM=cpu, and a ``jax``
    on PYTHONPATH that refuses to import, so neither the launcher nor any
    process it starts can run the JAX package."""
    shadow = tmp_path / "shadow" / "jax"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text(
        "raise ImportError('jax is blocked in this test')\n")
    env = dict(os.environ, PCS_PLATFORM="cpu",
               PYTHONPATH=str(tmp_path / "shadow"))
    return env


@time_limit(120)
def test_local_cluster_torch_stitches_on_the_cpu(tmp_path, no_jax_env):
    save = tmp_path / "clouds"
    base = _free_base_port(2)
    proc = _run([sys.executable, os.path.join(SCRIPTS,
                                              "local_cluster_torch.py"),
                 "--cameras", "2", "--frames", "3", "--height", "120",
                 "--width", "212", "--base-port", str(base),
                 "--client-args", f"--save-dir {save} --print-every 0"],
                env=no_jax_env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("fake camera server on ") for line in
               lines) == 2
    assert "streaming from 2 cameras on cpu" in proc.stdout
    summary = json.loads(lines[-1])
    assert summary["frames"] == 3 and summary["dropped_cameras"] == 0
    plys = sorted(save.glob("cloud_*.ply"))
    assert plys and plys[0].stat().st_size > 1000


@time_limit(60)
def test_local_cluster_torch_fails_when_a_server_does_not_come_up(
        no_jax_env):
    """The launcher's base port is taken: the first server cannot bind, and
    the launcher exits non-zero naming it instead of stitching fewer
    cameras."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        proc = _run([sys.executable,
                     os.path.join(SCRIPTS, "local_cluster_torch.py"),
                     "--cameras", "2", "--frames", "3", "--height", "120",
                     "--width", "212", "--base-port", str(port)],
                    env=no_jax_env)
    assert proc.returncode != 0
    assert f"camera server 0 (port {port}) did not come up" in proc.stderr
    assert "streaming from" not in proc.stdout


def _kill_pattern() -> str:
    with open(os.path.join(SCRIPTS, "kill_cameras_torch.sh")) as f:
        (pattern,) = re.findall(r"^PATTERN='([^']+)'$", f.read(), re.M)
    return pattern


def test_the_kill_pattern_matches_the_port_server_only():
    pattern = re.compile(_kill_pattern())
    port = "python -m pointcloud_stitching_tpu_torch.runtime.fake_server"
    jax = "python -m pointcloud_stitching_tpu.runtime.fake_server"
    assert pattern.search(port + " --port 8000")
    assert not pattern.search(jax + " --port 8000")
    # the remote shell that runs pkill carries the pattern, not the name
    assert not pattern.search(f"bash -c pkill -f '{pattern.pattern}'")


def _port_open(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
        return True
    except OSError:
        return False


@time_limit(90)
def test_camera_host_scripts_start_and_kill_the_port_server(tmp_path):
    """start_cameras_torch.sh then kill_cameras_torch.sh against this host
    (an ``ssh`` on PATH that runs the command here). The kill spares a
    process whose command line names the JAX package's server."""
    stub = tmp_path / "bin"
    stub.mkdir()
    (stub / "ssh").write_text('#!/usr/bin/env bash\n'
                              '# skip the options and the host; run the '
                              'command here\n'
                              'exec bash -c "${@: -1}"\n')
    (stub / "ssh").chmod(0o755)
    port = _free_base_port(1)
    hosts = tmp_path / "hosts.txt"
    hosts.write_text(f"# one capture host\nlocalhost:{port}\n")
    env = dict(os.environ, PATH=f"{stub}{os.pathsep}{os.environ['PATH']}",
               REPO_DIR=REPO, TMPDIR=str(tmp_path))
    jax_lookalike = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(120)",
         "pointcloud_stitching_tpu.runtime.fake_server"])
    try:
        start = _run(["bash", os.path.join(SCRIPTS, "start_cameras_torch.sh"),
                      str(hosts), "--host", "127.0.0.1", "--n-frames", "2",
                      "--height", "48", "--width", "64"], env=env, timeout=60)
        assert start.returncode == 0, start.stderr
        assert "started 1 camera servers" in start.stdout
        t0 = time.monotonic()
        while not _port_open(port):
            assert time.monotonic() - t0 < 60, (
                "the port's server never listened: "
                + (tmp_path / "pcs-torch-camera-0.log").read_text())
            time.sleep(0.2)
        kill = _run(["bash", os.path.join(SCRIPTS, "kill_cameras_torch.sh"),
                     str(hosts)], env=env, timeout=60)
        assert kill.returncode == 0, kill.stderr
        t0 = time.monotonic()
        while _port_open(port):
            assert time.monotonic() - t0 < 30, "the server outlived the kill"
            time.sleep(0.2)
        assert jax_lookalike.poll() is None, "the kill hit the JAX server"
    finally:
        subprocess.run(["pkill", "-f", f"{_kill_pattern()}.* --port {port} "],
                       timeout=30)
        jax_lookalike.kill()
        jax_lookalike.wait(timeout=30)


# the four commands whose main once returned a value (FrameMetrics, a face
# or cluster count), which sys.exit turned into a failing exit status:
# command -> (module, set-up code, argv as a Python expression)
_SERVE = ("from pointcloud_stitching_tpu_torch.runtime.fake_server import "
          "FakeCameraServer, synthetic_frames\n"
          "srv = FakeCameraServer(synthetic_frames(3, 60, 106)).start()\n")
EXIT_CASES = {
    "pcs-torch-stitch": (
        "runtime.stitch_cli", _SERVE,
        "['--camera', f'127.0.0.1:{srv.port}', '--height', '60', "
        "'--width', '106', '--frames', '2', '--print-every', '0']"),
    "pcs-torch-camera-test": (
        "runtime.camera_test", _SERVE,
        "['--port', str(srv.port), '--frames', '2', '--deproject']"),
    "pcs-torch-mesh": (
        "tools.mesh_cli",
        "import numpy as np\n"
        "np.save('d.npy', np.full((48, 64), 1000, np.uint16))\n",
        "['d.npy', 'mesh.ply']"),
    "pcs-torch-segment": (
        "tools.segment_cli",
        "import numpy as np\n"
        "from pointcloud_stitching_tpu_torch.io import save_ply\n"
        "rng = np.random.default_rng(0)\n"
        "floor = np.c_[rng.uniform(-1, 1, (600, 2)), np.zeros(600)]\n"
        "blob = rng.normal(0, 0.05, (200, 3)) + 0.5\n"
        "save_ply('scene.ply', np.concatenate([floor, blob]))\n",
        "['scene.ply', 'out', '--drop-plane', '0.01', '--min-size', '20']"),
}


@time_limit(120)
@pytest.mark.parametrize("command", sorted(EXIT_CASES))
def test_the_command_exits_0_after_a_good_run(command, tmp_path,
                                              no_jax_env):
    """The console script runs ``sys.exit(main())``: after a good run the
    port's main returns 0 (the JAX package's returns its metrics or a
    count, which exits with status 1 or the count mod 256)."""
    module, setup, argv = EXIT_CASES[command]
    target = f"pointcloud_stitching_tpu_torch.{module}:main"
    assert _scripts()[command] == target
    code = (f"import sys\n{setup}"
            f"from pointcloud_stitching_tpu_torch.{module} import main\n"
            f"sys.exit(main({argv}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True,
                          env=dict(no_jax_env, PYTHONPATH=os.pathsep.join(
                              [no_jax_env["PYTHONPATH"], REPO])),
                          timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.strip(), "the command printed nothing"
