"""Model zoo."""

from deeplearning4j_tpu_torch.zoo.models import (BF16, F16, F32,
                                                 VGG16_MEAN_RGB,
                                                 char_rnn, gpt_mini,
                                                 gpt_mini_draft,
                                                 gpt_mini_tp_rules, lenet,
                                                 mnist_mlp, resnet18,
                                                 resnet50, vgg16,
                                                 vgg16_preprocess)

__all__ = ["BF16", "F16", "F32", "VGG16_MEAN_RGB", "char_rnn", "gpt_mini",
           "gpt_mini_draft", "gpt_mini_tp_rules", "lenet", "mnist_mlp", "resnet18", "resnet50",
           "vgg16", "vgg16_preprocess"]
