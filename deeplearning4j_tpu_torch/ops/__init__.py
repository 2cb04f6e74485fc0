"""Ops: activations, initializers, device dispatch and the LSTM op with
its Hopper kernel (csrc/)."""
