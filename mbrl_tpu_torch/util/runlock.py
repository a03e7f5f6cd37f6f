"""Advisory per-work-dir run lock: refuse two concurrent trainers on one dir.

Counterpart of ``mbrl_tpu/util/runlock.py``. Two resumed processes of one run
training into one work dir would interleave ``results.csv`` rows and
checkpoints from two diverging lineages; checkpoint/resume makes such
double-starts easy to trigger.

``run_lock(work_dir)`` is a context manager used by the ``train()`` entry
points:

- atomically creates ``<work_dir>/.run_lock`` containing this process's pid
  (write-to-temp + ``os.link``, so the file can never be observed empty);
- if the file exists and its pid is a LIVE process, raises
  ``RunLockedError`` (the second trainer stops before touching any artifact);
- if the pid is dead (crash/kill), the stale lock is stolen — checkpointed
  resumes keep their one-command workflow. Stealing unlinks and RETRIES the
  atomic create, so two simultaneous stealers race on the create and exactly
  one wins;
- re-entrant within one process (chunked sessions call ``train()`` per
  chunk): only the OUTERMOST acquisition removes the file on exit, an inner
  nested context never unlocks a still-training outer one;
- if the lock can neither be acquired nor stolen, the context REFUSES to run
  (no silent unguarded fallthrough).

The lock is advisory and per-host (pid semantics).
"""
from __future__ import annotations

import contextlib
import errno
import os
import pathlib
import tempfile
from typing import Iterator, Union


class RunLockedError(RuntimeError):
    """Another live process is already training into this work dir."""


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _read_pid(path: pathlib.Path) -> int:
    try:
        return int(path.read_text().strip() or "0")
    except (OSError, ValueError):
        return 0


def _try_create(path: pathlib.Path, pid: int) -> bool:
    """Atomically create ``path`` already containing ``pid``; False if it
    exists. Write-to-temp + hard-link means no reader can ever observe an
    empty/partial lock file (the O_EXCL-then-write scheme had a window where
    a concurrent process read pid 0 and stole a live lock)."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".run_lock_tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(str(pid))
        try:
            os.link(tmp, path)
            return True
        except OSError as e:
            if e.errno == errno.EEXIST:
                return False
            raise
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


@contextlib.contextmanager
def run_lock(work_dir: Union[str, os.PathLike]) -> Iterator[None]:
    """Hold the advisory lock on ``work_dir`` for the duration of a training
    run; raise :class:`RunLockedError` if a live process already holds it or
    the lock cannot be (re)claimed."""
    work_dir = pathlib.Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    path = work_dir / ".run_lock"
    me = os.getpid()
    created = False
    for _attempt in range(4):
        if _try_create(path, me):
            created = True
            break
        holder = _read_pid(path)
        if holder == me:
            break  # re-entrant within one process (chunked resumes)
        if _pid_alive(holder):
            raise RunLockedError(
                f"work dir {work_dir} is locked by live pid {holder} "
                f"({path}); a second concurrent trainer would interleave "
                "its checkpoints and results.csv rows with the first — "
                "stop that process (or wait for it) before resuming here"
            )
        # stale lock from a dead process (or unreadable garbage): steal it,
        # then RETRY the atomic create — of two simultaneous stealers only
        # one link() succeeds, the other loops and sees the winner's live pid
        with contextlib.suppress(OSError):
            path.unlink()
    else:
        raise RunLockedError(
            f"could not acquire {path} after repeated steal attempts "
            "(filesystem refusing unlink/create?) — refusing to train "
            "unguarded"
        )
    try:
        yield
    finally:
        # only the outermost acquisition unlocks; a nested inner context
        # (created=False) must not unlock a still-training outer one
        if created and _read_pid(path) == me:
            with contextlib.suppress(OSError):
                path.unlink()
