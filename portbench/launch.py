"""Starting the ranks of a cell that spans several cards.

The process that the command starts is rank 0. It starts ranks 1..N-1 as
processes of the same command, gives each the port's process-group
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port), and waits for them. A watchdog ends
the run at once when a rank fails, rather than leaving the others in a
collective until its timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


class Ranks:
    """Ranks 1..world-1 of ``python -m <module> <argv>``; this process is
    rank 0 and takes its environment from ``env0``."""

    def __init__(self, module, argv, world):
        port = free_port()
        self.env0 = rank_env(0, world, port)
        self.procs = []
        for r in range(1, world):
            env = dict(os.environ, **rank_env(r, world, port))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv], env=env,
                stdout=subprocess.DEVNULL))
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def _watchdog(self):
        while not self._stop.wait(1.0):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    print(f"portbench: rank {r} exited with {p.returncode}; "
                          "ending the run", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(3)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self, timeout=120):
        """Wait for every rank; their exit codes."""
        self._stop.set()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes
