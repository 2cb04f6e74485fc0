"""The compile cache's model fingerprint (counterpart of
deeplearning4j_tpu/compilecache/).

Ported: ``manifest.model_fingerprint``, the structure key that
``serving/publish.py`` stamps on a publication and that
``ModelServer.hot_swap`` checks. The rest of the package (the
persistent cache, the AOT manifest, precompile, the autotuner) waits for
ROADMAP.md A.4.
"""

from deeplearning4j_tpu_torch.compilecache.manifest import model_fingerprint

__all__ = ["model_fingerprint"]
