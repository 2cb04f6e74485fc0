"""Observability / UI (counterpart of deeplearning4j_tpu/ui/; parity:
deeplearning4j-ui-parent): StatsListener -> StatsStorage -> web
dashboard, with remote routing, embeddings and the report components."""

from deeplearning4j_tpu_torch.ui.stats import StatsListener, StatsReport
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage,
    InMemoryStatsStorage,
)
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.router import RemoteStatsStorageRouter
from deeplearning4j_tpu_torch.ui.embedding import publish_embedding
