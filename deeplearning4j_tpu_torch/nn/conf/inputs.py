"""InputType — shape metadata for n_in inference (counterpart of
deeplearning4j_tpu/nn/conf/inputs.py, same fields and JSON form).

Kinds: feed_forward(size), recurrent(size, timesteps=None) for
[batch, time, size] inputs, convolutional(height, width, channels),
convolutional_flat(height, width, channels).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class InputType:
    kind: str
    size: int | None = None
    timesteps: int | None = None
    height: int | None = None
    width: int | None = None
    channels: int | None = None

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feed_forward", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: int | None = None) -> "InputType":
        return InputType(kind="recurrent", size=int(size),
                         timesteps=None if timesteps is None else int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=int(height),
                         width=int(width), channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType(kind="convolutional_flat", height=int(height),
                         width=int(width), channels=int(channels),
                         size=int(height) * int(width) * int(channels))

    def flat_size(self) -> int:
        if self.kind in ("feed_forward", "recurrent"):
            return self.size
        return self.height * self.width * self.channels

    def to_dict(self):
        return {k: v for k, v in asdict(self).items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
