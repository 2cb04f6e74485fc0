"""Model zoo."""

from deeplearning4j_tpu_torch.zoo.models import (BF16, F32, char_rnn,
                                                 gpt_mini, gpt_mini_draft,
                                                 resnet50)

__all__ = ["BF16", "F32", "char_rnn", "gpt_mini", "gpt_mini_draft",
           "resnet50"]
