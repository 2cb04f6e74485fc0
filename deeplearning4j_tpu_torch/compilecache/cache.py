"""The kernel build cache as a first-class runtime knob (counterpart of
deeplearning4j_tpu/compilecache/cache.py).

The JAX package's cache holds XLA executables. The port's compiled
programs are the ``nvcc`` builds of ``ops/csrc/*.cu`` (ops/_build.py),
so this module owns their directory:

- :func:`configure` points ``_build``'s build directory at a cache dir;
  the dir resolves from an explicit argument or the
  ``DL4J_TPU_COMPILE_CACHE`` environment variable. There are no jax
  flags to zero and no latched handle to reset: a library's file name
  carries the hash of its sources, flags, headers and ``nvcc`` release,
  so any library found there is the one this process would build.
- Hit/miss traffic is observable: every ``nvcc`` build counts as a
  compile and a ``dl4j_xla_cache_misses_total``, every library loaded as
  found on disk as a ``dl4j_xla_cache_hits_total`` (the JAX package's
  family names), and both land on the RunReport's ``xla_cache_hits`` /
  ``xla_cache_misses``. A warm boot proves itself: 0 misses, 0 builds.

**Shared directory (cross-host).** The dir may be a mount a fleet
shares: the first host's builds are every later host's hits. What makes
it safe to share:

- ``_build`` writes each library under a name unique to its process and
  thread and renames it into place, so a reader never loads a partial
  library;
- :func:`configure` stamps the dir with an atomically published
  ``dl4j_cache_meta.json`` marker (:func:`atomic_publish`): N processes
  configuring one dir at once race benignly, every writer replaces a
  complete file, the first valid marker is kept and no ``*.tmp`` file
  survives;
- re-configuring is idempotent for each resolved dir, across threads and
  processes.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Optional

from deeplearning4j_tpu_torch.ops import _build

#: consulted by :func:`ensure_configured` (fit, the supervisor, the
#: server and every kernel build or load call it): set it and every run
#: in the process shares one build cache without touching call sites
ENV_VAR = "DL4J_TPU_COMPILE_CACHE"

#: the shared-dir marker :func:`configure` publishes atomically: its
#: presence (and valid JSON-ness) is the "this dir is a dl4j compile
#: cache" handshake between hosts sharing the mount
META_NAME = "dl4j_cache_meta.json"
META_SCHEMA_VERSION = 1

_lock = threading.Lock()
_configured: Optional[str] = None


def atomic_publish(directory: str, name: str, payload: dict) -> str:
    """Write ``payload`` as JSON to ``directory/name`` by tmp + rename:
    serialize to a tmp file whose name is unique per process and thread
    (pid + uuid), fsync, then ``os.replace`` onto the final name. A
    concurrent reader sees the old complete file or the new one, never a
    torn write. Returns the final path."""
    final = os.path.join(directory, name)
    tmp = os.path.join(
        directory, f".{name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        # a crash between write and replace must not leave tmp litter
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return final


def shared_meta(path: Optional[str] = None) -> Optional[dict]:
    """The shared-dir marker of ``path`` (default: the active cache
    dir), or None when the dir is unstamped or unreadable."""
    d = path or _configured
    if not d:
        return None
    try:
        with open(os.path.join(d, META_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _stamp_shared_dir(resolved: str) -> None:
    """Publish the marker unless the dir already carries a valid one (the
    first writer's identity stays recorded; a corrupt marker is
    replaced). Never raises: a read-only shared mount still serves
    hits, it just stays unstamped."""
    if shared_meta(resolved) is not None:
        return
    try:
        from deeplearning4j_tpu_torch.observability.distributed import \
            get_identity
        created_by = get_identity().tag
    except Exception:
        created_by = f"pid-{os.getpid()}"
    try:
        atomic_publish(resolved, META_NAME, {
            "schema": META_SCHEMA_VERSION,
            "created_unix": round(time.time(), 3),
            "created_by": created_by,
        })
    except OSError:
        pass


def cache_dir() -> Optional[str]:
    """The active build-cache directory, or None (``_build.BUILD_DIR``)."""
    return _configured


def configure(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds and loads at *path* (or at
    ``$DL4J_TPU_COMPILE_CACHE`` when *path* is None) and stamp it.
    Idempotent per dir; switching dirs mid-process takes effect for the
    next library built or loaded. Returns the active dir (None when
    neither source names one: nothing changes)."""
    global _configured
    resolved = path or os.environ.get(ENV_VAR) or None
    if not resolved:
        return _configured
    resolved = os.path.abspath(resolved)
    with _lock:
        if _configured == resolved:
            return _configured
        os.makedirs(resolved, exist_ok=True)
        _stamp_shared_dir(resolved)
        _build.set_build_dir(resolved)
        _configured = resolved
    return _configured


def deactivate() -> None:
    """Point builds back at the package's own ``_build.BUILD_DIR``.
    Process-global, like :func:`configure`: meant for tear-down (tests,
    embedding hosts), not the serving hot path."""
    global _configured
    with _lock:
        if _configured is None:
            return
        _build.set_build_dir(None)
        _configured = None


def ensure_configured() -> Optional[str]:
    """Environment-driven activation: a no-op unless
    ``DL4J_TPU_COMPILE_CACHE`` is set (or :func:`configure` already
    ran). The fit loops, the supervisor, the server and every kernel
    build or load call this, so one exported variable gives warm boots
    across the whole stack."""
    return configure(None)
