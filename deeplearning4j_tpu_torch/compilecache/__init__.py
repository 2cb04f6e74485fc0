"""Cold start: the kernel build cache, the AOT manifest, precompile and
the serving autotuner (counterpart of deeplearning4j_tpu/compilecache/).

The port's compiled programs are the ``nvcc`` builds of
``ops/csrc/*.cu`` (ops/_build.py), so its persistent compilation cache is
their build directory:

- :mod:`cache`: ``configure(dir)`` / ``$DL4J_TPU_COMPILE_CACHE`` point
  the builds at a directory, possibly one a fleet shares (stamped with
  an atomically published marker); ``ModelServer``/``serve()``, ``fit``
  and the supervisor configure it. Hits and misses land in
  ``dl4j_xla_cache_hits_total`` / ``_misses_total`` and on the RunReport.
- :mod:`manifest` + :mod:`precompile`: build the libraries a deploy
  needs and warm its ladders before the deploy, with a schema'd manifest
  the server validates at boot (a mismatch warns and builds at first
  use); :func:`manifest.model_fingerprint` is also the hot swap's key.
- :mod:`autotune`: replay a recorded traffic trace through a simulator
  of the batcher and search (max_batch, linger window) for the lowest
  p99 x padding waste; the server loads the winner via
  ``tuning_report=``.
"""

from deeplearning4j_tpu_torch.compilecache.cache import (ENV_VAR, META_NAME,
                                                         atomic_publish,
                                                         cache_dir,
                                                         configure,
                                                         deactivate,
                                                         ensure_configured,
                                                         shared_meta)
from deeplearning4j_tpu_torch.compilecache.manifest import model_fingerprint

__all__ = ["ENV_VAR", "META_NAME", "cache_dir", "configure", "deactivate",
           "ensure_configured", "atomic_publish", "shared_meta",
           "model_fingerprint"]
