"""Launcher: spawn the WebSocket backend and the UI frontend, monitor both,
tear down together (mirror of reference run.py:21-65).  Mic mode needs the
optional ``sounddevice`` package; without it the backend serves files only.

    python run.py [--backend-port 8765] [--ui-port 8050]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def run_services(backend_port: int, ui_port: int):
    env = dict(os.environ, PORT=str(backend_port), BACKEND_PORT=str(backend_port))
    procs = {}
    # SIGTERM must tear the children down too (KeyboardInterrupt only
    # covers Ctrl-C): without this, killing the launcher leaks the
    # backend + UI processes — and a leaked backend holds the GPU.
    def _terminate(_sig, _frame):
        # One-shot: once teardown has begun, a second SIGTERM (impatient
        # supervisor, `docker stop` escalation) must not interrupt the
        # finally-block child cleanup — that would leak the backend, and
        # a leaked backend holds the GPU's memory.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terminate)
    try:
        print(f"Starting backend on port {backend_port}...")
        procs["backend"] = subprocess.Popen(
            [sys.executable, "-m", "aefs_tpu.server.backend"], env=env
        )
        time.sleep(1)
        print(f"Starting UI on port {ui_port}...")
        env_ui = dict(env, UI_PORT=str(ui_port))
        procs["ui"] = subprocess.Popen(
            [sys.executable, "-m", "aefs_tpu.ui.app"], env=env_ui
        )
        print(f"Open http://localhost:{ui_port}")

        while True:
            time.sleep(1)
            for name, p in procs.items():
                if p.poll() is not None:
                    print(f"Service '{name}' exited ({p.returncode}); shutting down")
                    return
    except KeyboardInterrupt:
        print("\nShutting down...")
    finally:
        # Mask BOTH signals unconditionally before touching the children:
        # the one-shot SIGTERM handler only covers the SIGTERM->SIGTERM
        # case — a Ctrl-C-initiated teardown interrupted by SIGTERM (or a
        # second Ctrl-C) would otherwise abandon the cleanup mid-loop and
        # leak the backend holding the GPU.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 5
        for p in procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend-port", type=int, default=int(os.environ.get("PORT", 8765)))
    ap.add_argument("--ui-port", type=int, default=int(os.environ.get("UI_PORT", 8050)))
    args = ap.parse_args()
    run_services(args.backend_port, args.ui_port)
