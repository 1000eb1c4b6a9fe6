"""A model family for the tests: the default family's block with a GeGLU
FFN (the tanh approximation of gelu on the gate), which the default
family's builder cannot express and the port runs (``activation="gelu"``).
It shares the default family's weights and FLOP count."""
import dataclasses

import torch.nn.functional as F

import arith
import refmodel
import weights
from harness import transformer_config

layout = weights.layout
row_flops = arith.row_flops


def program_config(tf, m):
    return dataclasses.replace(transformer_config(tf, m), activation="gelu")


class Reference(refmodel.Reference):
    def _ffn(self, wi, wo, h):
        gate, up = self._mm(h, wi).chunk(2, dim=-1)
        act = F.gelu(gate, approximate="tanh")
        return self._mm(refmodel._bf(refmodel._bf(act) * up), wo)
