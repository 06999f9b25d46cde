"""Child processes with a bound on their life.

Every child the port starts (the compilers, the ranks of a data-parallel
run, a serving process) starts in a session of its own, writes its
output to a file rather than to a pipe it could inherit, is waited on
with a hard timeout, and has its whole process group killed when the
wait ends, however it ends. A child that outlived its caller would keep
the caller's output pipe open and hold the card.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile


def start(cmd, log_path, env=None, cwd=None) -> subprocess.Popen:
    """Start ``cmd`` in a new session, stdin closed, stdout and stderr
    both to ``log_path``."""
    with open(log_path, "w") as log:
        return subprocess.Popen(
            cmd, stdin=subprocess.DEVNULL, stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=cwd,
            start_new_session=True)


def kill_group(proc: subprocess.Popen):
    """SIGKILL the process group ``proc`` leads (its session: the child and
    anything it started), then reap ``proc``."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def wait(proc: subprocess.Popen, timeout: float) -> int:
    """``proc``'s exit code within ``timeout`` s; its group is killed on
    the way out, also on a timeout (``subprocess.TimeoutExpired``)."""
    try:
        return proc.wait(timeout=timeout)
    finally:
        kill_group(proc)


def run(cmd, timeout: float, env=None, cwd=None):
    """Run ``cmd`` to its end, bounded as above; returns (exit code, its
    stdout and stderr as one text)."""
    fd, log_path = tempfile.mkstemp(prefix="flownet2_child_", suffix=".log")
    os.close(fd)
    try:
        rc = wait(start(cmd, log_path, env=env, cwd=cwd), timeout)
        with open(log_path, errors="replace") as f:
            return rc, f.read()
    finally:
        os.remove(log_path)
