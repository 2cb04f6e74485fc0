"""Model zoo."""

from deeplearning4j_tpu_torch.zoo.models import BF16, F32, char_rnn

__all__ = ["BF16", "F32", "char_rnn"]
