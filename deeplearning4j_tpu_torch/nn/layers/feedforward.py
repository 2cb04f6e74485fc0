"""Dense, output, loss, activation, dropout and embedding runtime layers
(counterpart of deeplearning4j_tpu/nn/layers/feedforward.py:
``DenseLayer``, ``OutputLayer``, ``LossOnlyLayer``,
``ActivationOnlyLayer``, ``DropoutOnlyLayer``, ``EmbeddingLayerImpl``).

The product runs in the layer's compute dtype (bf16 under the BF16
policy, params stay f32); the output heads form their activation and
their loss in the param dtype.

On a mesh's model axis (``use_mesh(model_axis=)``, parallel/tensor.py)
a layer whose W is column- or row-parallel computes its pre-activation
on its shard (``LayerTP.dense``: a column-sharded result is gathered
whole before the activation, which may mix features, and the loss); an
embedding table sharded by columns looks up its columns and gathers.

The F32 inference product on the card runs on S1 (``dense_product``),
so a column shard's product is the whole product's columns bit for bit:
``net.output`` and the mesh-serving walk (parallel/inference.py) give
the same rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import initializers as init_mod
from deeplearning4j_tpu_torch.ops import losses as losses_mod
from deeplearning4j_tpu_torch.ops import registry, stream_exact


def dense_product(x, W, b, cd):
    """x @ W (+ b) in the compute dtype ``cd``: on S1 where
    ``stream_exact.dense_route`` says "stream" (the F32 forward on the
    card with no grad, as under ``net.output``'s inference mode; counted
    as ``dense:route[stream]``), whose sums over the input width run in
    one order whatever the rows and the output width; else one
    ``torch.matmul`` with the bias added in ``cd`` (training, other
    dtypes, the CPU)."""
    if stream_exact.dense_route(cd, x.device,
                                torch.is_grad_enabled()) == "stream":
        registry.count_launch(stream_exact.DENSE_ROUTED)
        return stream_exact.stream_dense(
            x.to(cd).contiguous(), W.to(cd).contiguous(),
            None if b is None else b.to(cd).contiguous())
    z = torch.matmul(x.to(cd), W.to(cd))
    if b is not None:
        z = z + b.to(cd)
    return z


class DenseLayer(Layer):
    def init_params(self, gen, device):
        n_in, n_out = self.conf.n_in, self.conf.n_out
        w_fn = init_mod.resolve(self.resolve("weight_init", "xavier"))
        params = {"W": w_fn(gen, (n_in, n_out), n_in, n_out,
                            self.param_dtype, device)}
        if getattr(self.conf, "has_bias", True):
            params["b"] = torch.full(
                (n_out,), float(self.resolve("bias_init", 0.0)),
                dtype=self.param_dtype, device=device)
        return params

    def preout(self, params, x):
        cd = self.compute_dtype
        if self.tp is not None and self.tp.rendered:
            return self.tp.dense(x, params["W"], params.get("b"), cd)
        return dense_product(x, params["W"], params.get("b"), cd)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        return self.activation_fn(self.preout(params, x)), state


class OutputLayer(DenseLayer):
    """Dense layer + loss head."""

    @property
    def loss_fn(self) -> losses_mod.Loss:
        return losses_mod.get(self.conf.loss)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        # the head's activation in the param dtype, so served outputs are
        # full precision under any policy
        x = self._input_dropout(x, train, gen)
        z = self.preout(params, x).to(self.param_dtype)
        return self.activation_fn(z), state

    def loss(self, params, x, labels, *, train=False, gen=None, mask=None):
        x = self._input_dropout(x, train, gen)
        z = self.preout(params, x).to(self.param_dtype)
        return self.loss_fn.score(labels.to(z.dtype), z, self.activation_fn,
                                  mask)


class ActivationOnlyLayer(Layer):
    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        return self.activation_fn(x), state


class LossOnlyLayer(Layer):
    """Parameter-free loss head: the activation of its input, and the loss
    of that input in the param dtype."""

    @property
    def loss_fn(self) -> losses_mod.Loss:
        return losses_mod.get(self.conf.loss)

    def preout(self, params, x):
        return x

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        return self.activation_fn(x), state

    def loss(self, params, x, labels, *, train=False, gen=None, mask=None):
        z = x.to(self.param_dtype)
        return self.loss_fn.score(labels.to(z.dtype), z, self.activation_fn,
                                  mask)


class DropoutOnlyLayer(Layer):
    """Standalone dropout: the layer's ``dropout`` (or the global one) is
    the drop probability, drawn from the net's generator."""

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        return self._input_dropout(x, train, gen), state


class EmbeddingLayerImpl(DenseLayer):
    """Embedding lookup plus bias, in the param dtype (the JAX package's
    ``jnp.take`` of W). ``x`` holds integer indices, [batch] or a column
    [batch, 1] (a float column is truncated to int32, as there), or
    one-hot rows [batch, n_in] of a float dtype (their argmax). The gather
    is ``F.embedding``, whose backward sums the rows of one index without
    atomics (``index_select``'s is an atomic ``index_add_``), so a
    captured step equals an eager one bit for bit. An index outside
    [0, n_in) raises here (on the card a device assert), where the JAX
    package's ``take`` fills NaN. W and b as a dense layer's."""

    def indices(self, x):
        """The int32 row index of each example."""
        if (x.dim() == 2 and x.shape[-1] == self.conf.n_in
                and x.is_floating_point()):
            return torch.argmax(x, dim=-1).to(torch.int32)
        return x.reshape(x.shape[0]).to(torch.int32)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        tp = self.tp if self.tp is not None and self.tp.rendered else None
        emb = F.embedding(self.indices(x), params["W"])
        if "b" in params:
            emb = emb + (params["b"] if tp is None
                         else tp.bias(params["b"], "b"))
        if tp is not None:   # this rank's columns of the table
            emb = tp.gather(emb)
        return self.activation_fn(emb), state
