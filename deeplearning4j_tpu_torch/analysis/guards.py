"""``@guarded_by`` — declare which lock protects which attributes
(counterpart of deeplearning4j_tpu/analysis/guards.py).

Threaded classes register their lock-guarded state at class level:

    @guarded_by("_cond", "_pending", "_stopping", "_crashed", "_thread")
    class MicroBatcher: ...

The declaration does two jobs:

- **Statically** (analysis/concurrency.py, the JAX package's pass): the
  AST lint reads the
  decorator literally and flags any write to a registered attribute
  (assignment, augmented assignment, item write/delete, or a mutator
  method call like ``.append``/``.clear``/``.update``) that is not
  lexically inside ``with self.<lock>:`` — the DL4J-C005 finding.
  Methods whose name ends in ``_locked`` are treated as running with
  the lock already held (the existing ``_gather_locked`` convention),
  and ``__init__`` is exempt (no other thread can hold a reference
  yet).
- **At runtime**: the registry is kept on the class as
  ``__guarded_by__`` (attr -> lock attr name) so tests and tools can
  introspect the declared contract.

The decorator itself is deliberately free: no wrapping, no
``__setattr__`` hook, zero per-access cost — enforcement lives in the
lint, not the hot path. This module must therefore stay import-light
(the threaded serving/datapipe modules import it).
"""

from __future__ import annotations

__all__ = ["guarded_by"]


def guarded_by(lock_attr: str, *attrs: str):
    """Class decorator: register ``attrs`` as guarded by
    ``self.<lock_attr>``. Stack multiple decorators when a class uses
    more than one lock. The registry accumulates across subclasses."""
    if not attrs:
        raise ValueError("guarded_by needs at least one guarded attribute")

    def deco(cls):
        reg = dict(getattr(cls, "__guarded_by__", {}))
        for a in attrs:
            reg[a] = lock_attr
        cls.__guarded_by__ = reg
        return cls

    return deco
