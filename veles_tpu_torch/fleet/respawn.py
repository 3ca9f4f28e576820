"""Slave respawn: relaunch dead slaves on their hosts.

The port's copy of ``veles_tpu/fleet/respawn.py``: a slave is
relaunched as ``python -m veles_tpu_torch``.

Reference ``--respawn`` (``server.py:637-655`` + ``launcher.py:617-660``
``launch_remote_progs``): each slave's handshake carries its relaunch
recipe (executable, argv, cwd, PYTHONPATH); when a slave dies and does
not reconnect within a grace window, the master re-executes it — over
SSH for remote hosts, a plain subprocess for local ones — with
exponential backoff and a bounded attempt budget.

The actual process launch is a pluggable ``spawner(host, command, cwd,
env)`` so clusters with non-SSH launchers (k8s, slurm) slot in, and
tests inject a recorder.
"""

import os
import shlex
import subprocess
import threading

from veles_tpu_torch.core.logger import Logger

LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1")

#: env keys that must NEVER ride a remote command line — `ps` on either
#: end of the ssh session would expose them to any local user
SENSITIVE_ENV = ("VELES_TPU_FLEET_SECRET",)


def default_spawner(host, command, cwd=None, env=None):
    """ssh for remote hosts, a detached subprocess for local ones."""
    if host in LOCAL_HOSTS:
        full_env = dict(os.environ)
        full_env.update(env or {})
        return subprocess.Popen(
            command, shell=True, cwd=cwd, env=full_env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True)
    parts = ["ssh", "-o", "BatchMode=yes", host]
    env = dict(env or {})
    secret_items = [(k, env.pop(k)) for k in list(env)
                    if k in SENSITIVE_ENV]
    # env assignments must sit INSIDE the cd && chain — prefixed outside
    # they would scope to the `cd` builtin only
    for key, value in env.items():
        command = "%s=%s %s" % (key, shlex.quote(value), command)
    if cwd:
        command = "cd %s && %s" % (shlex.quote(cwd), command)
    stdin_data = None
    if secret_items:
        # secrets are piped over the (encrypted) ssh stdin and exported
        # by the remote shell before exec — never visible in argv
        command = ('while IFS="=" read -r __k __v; do export '
                   '"$__k"="$__v"; done; ' + command)
        stdin_data = "".join("%s=%s\n" % item
                             for item in secret_items).encode()
    parts.append(command)
    proc = subprocess.Popen(
        parts, stdin=subprocess.PIPE if stdin_data else None,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    if stdin_data:
        try:
            proc.stdin.write(stdin_data)
            proc.stdin.close()
        except OSError:
            # ssh died before reading (unreachable host, BatchMode
            # refusal): losing this one slave must not abort the caller
            # (the -n startup path has no catch of its own)
            pass
    return proc


def build_command(executable, argv):
    """One shell-quoted command line — THE quoting/join used by every
    spawn path (respawn and ``-n`` startup launch)."""
    return "%s %s" % (shlex.quote(executable),
                      " ".join(shlex.quote(a) for a in argv))


def spawn_env(pythonpath):
    """Env dict a spawned slave needs, or None when nothing does."""
    return {"PYTHONPATH": pythonpath} if pythonpath else None


def respawn_recipe():
    """The slave-side handshake payload (reference ``client.py:362-373``
    shipped argv/cwd/PYTHONPATH for exactly this). A ``python -m
    veles_tpu_torch`` invocation is re-encoded as ``-m veles_tpu_torch``
    (sys.argv[0]
    is the __main__.py path, which in script mode would lose the package
    parent from sys.path)."""
    import sys
    argv = list(sys.argv)
    if argv and argv[0].endswith(os.path.join("veles_tpu_torch",
                                              "__main__.py")):
        argv = ["-m", "veles_tpu_torch"] + argv[1:]
    return {
        "executable": sys.executable,
        "argv": argv,
        "cwd": os.getcwd(),
        "pythonpath": os.environ.get("PYTHONPATH", ""),
    }


class RespawnManager(Logger):
    """Master-side relauncher with per-host backoff + attempt budget."""

    def __init__(self, spawner=None, max_attempts=5, base_delay=2.0,
                 extra_env=None):
        super().__init__()
        self.spawner = spawner or default_spawner
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        #: forwarded to every spawned slave (e.g. the fleet secret when
        #: it came from the master's environment — a slave without it
        #: would fail every HMAC and never join)
        self.extra_env = dict(extra_env or {})
        self._attempts = {}
        self._lock = threading.Lock()
        self._timers = []
        self._stopped = False

    @staticmethod
    def command_of(recipe):
        argv = list(recipe.get("argv") or [])
        executable = recipe.get("executable")
        if not executable or not argv:
            return None
        if "-b" not in argv and "--background" not in argv:
            # detach, like the reference; after the script/module part
            at = 2 if argv[0] == "-m" and len(argv) > 1 else 1
            argv.insert(at, "-b")
        return build_command(executable, argv)

    def schedule(self, host, recipe, key=None):
        """Respawn the slave described by ``recipe`` on ``host`` after the
        backoff delay. Returns False when out of budget / bad recipe."""
        command = self.command_of(recipe or {})
        if command is None:
            self.warning("cannot respawn: recipe incomplete")
            return False
        key = key or host
        with self._lock:
            if self._stopped:
                return False
            attempt = self._attempts.get(key, 0)
            if attempt >= self.max_attempts:
                self.warning("respawn budget exhausted for %s", key)
                return False
            self._attempts[key] = attempt + 1
        delay = self.base_delay * (2 ** attempt)
        self.info("respawning slave on %s in %.0fs (attempt %d/%d)",
                  host, delay, attempt + 1, self.max_attempts)
        env = spawn_env(recipe.get("pythonpath")) or {}
        env.update(self.extra_env)
        timer = threading.Timer(
            delay, self._spawn, (host, command, recipe.get("cwd"), env))
        timer.daemon = True
        with self._lock:
            if self._stopped:
                return False
            # prune fired timers so a long-lived master with flapping
            # slaves doesn't accumulate one Timer per schedule() forever
            self._timers = [t for t in self._timers if t.is_alive()]
            self._timers.append(timer)
        timer.start()
        return True

    def notify_reconnected(self, key):
        """A slave came back on its own: reset its budget."""
        with self._lock:
            self._attempts.pop(key, None)

    def _spawn(self, host, command, cwd, env):
        try:
            self.spawner(host, command, cwd=cwd, env=env)
        except Exception as exc:
            self.warning("respawn on %s failed: %s", host, exc)

    def stop(self):
        with self._lock:
            self._stopped = True
            timers = list(self._timers)
        for timer in timers:
            timer.cancel()
