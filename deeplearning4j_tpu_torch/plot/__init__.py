"""Dimensionality reduction (counterpart of deeplearning4j_tpu/plot/;
parity: deeplearning4j-core plot/ — Tsne.java, BarnesHutTsne.java)."""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne
