"""RepVGG A0 and B3, the train form and the re-parameterized deploy form.

Counterpart of ``robustart_tpu/models/repvgg.py``. The train form's block is
three branches, each with its own BatchNorm (eps 1e-5): a 3×3 conv, a 1×1
conv and, where the stride is 1 and the width stays, the identity.
:func:`reparameterize` folds them into one 3×3 conv with bias per block
(``reparameterize_params``, :93-140), in float32 in the JAX package's order
of operations, and returns the ``deploy=True`` model. Module names follow
DingXiaoH/RepVGG (``stage0.rbr_dense.{conv,bn}``, ``rbr_1x1``,
``rbr_identity``, ``stageS.I.…``, ``linear``; the deploy conv is its
``rbr_reparam``), as the JAX package's ``torch_convert.py:256-266`` names
them.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn

from robustart_torch.models.layers import ConvNet

BN_EPS = 1e-5


def _conv_bn(cin: int, cout: int, kernel: int, stride: int) -> nn.Sequential:
    out = nn.Sequential()
    out.add_module("conv", nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False))
    out.add_module("bn", nn.BatchNorm2d(cout, eps=BN_EPS))
    return out


class RepVGGBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = nn.Conv2d(cin, cout, 3, stride, 1)
            return
        self.rbr_dense = _conv_bn(cin, cout, 3, stride)
        self.rbr_1x1 = _conv_bn(cin, cout, 1, stride)
        self.rbr_identity = (nn.BatchNorm2d(cin, eps=BN_EPS)
                             if stride == 1 and cin == cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return torch.relu(self.rbr_reparam(x))
        out = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return torch.relu(out)


class RepVGG(ConvNet):
    HEAD = ("linear",)

    def __init__(self, num_blocks: Sequence[int], width_a: float, width_b: float,
                 num_classes: int = 1000, deploy: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.deploy = deploy
        self.num_blocks = tuple(num_blocks)
        self.width_a, self.width_b = width_a, width_b
        widths = [int(64 * min(width_a, 1.0)), int(128 * width_a), int(256 * width_a),
                  int(512 * width_b)]
        self.stage0 = RepVGGBlock(3, widths[0], 2, deploy)
        cin = widths[0]
        for si, (n, w) in enumerate(zip(self.num_blocks, widths)):
            blocks = []
            for bi in range(n):
                blocks.append(RepVGGBlock(cin, w, 2 if bi == 0 else 1, deploy))
                cin = w
            self.add_module(f"stage{si + 1}", nn.Sequential(*blocks))
        self.linear = nn.Linear(cin, num_classes)
        self.finish(dtype, num_classes)

    def blocks(self):
        yield "stage0", self.stage0
        for si in range(len(self.num_blocks)):
            for bi, block in enumerate(getattr(self, f"stage{si + 1}")):
                yield f"stage{si + 1}.{bi}", block

    def body(self, x):
        for _, block in self.blocks():
            x = block(x)
        return x

    def classify(self, x):
        return self.linear(x)


def _fuse_branch(kernel: torch.Tensor, bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a conv kernel (OIHW) and its BatchNorm into (kernel, bias), in
    float32 as ``_fuse_branch`` (:83-90) computes them."""
    gamma, beta = bn.weight.float(), bn.bias.float()
    mean, var = bn.running_mean.float(), bn.running_var.float()
    # the correctly rounded float32 square root, numpy's (torch's vectorized
    # float32 sqrt on the CPU is off by an ulp at times; float64 then rounding
    # is exact for a float32 argument)
    std = torch.sqrt((var + bn.eps).double()).float()
    return kernel * (gamma / std).reshape(-1, 1, 1, 1), beta - mean * gamma / std


@torch.no_grad()
def fused_weights(block: RepVGGBlock) -> tuple[torch.Tensor, torch.Tensor]:
    """A train-form block's three branches as one 3×3 (kernel, bias) in
    float32: 3×3 + the 1×1 at the centre tap + the identity's diagonal."""
    k3, b3 = _fuse_branch(block.rbr_dense.conv.weight.float(), block.rbr_dense.bn)
    k1, b1 = _fuse_branch(block.rbr_1x1.conv.weight.float(), block.rbr_1x1.bn)
    k1p = torch.zeros_like(k3)
    k1p[:, :, 1:2, 1:2] = k1
    fused_k, fused_b = k3 + k1p, b3 + b1
    if block.rbr_identity is not None:
        cin = k3.shape[1]
        ident = torch.zeros_like(k3)
        ident[torch.arange(cin), torch.arange(cin), 1, 1] = 1.0
        kid, bid = _fuse_branch(ident, block.rbr_identity)
        fused_k, fused_b = fused_k + kid, fused_b + bid
    return fused_k, fused_b


@torch.no_grad()
def reparameterize(model: RepVGG) -> RepVGG:
    """The deploy form of a train-form RepVGG: every block one 3×3 conv
    with bias (its weights in the model's type), the head copied, on the
    model's device and in eval mode. Mathematically the train form's
    logits up to rounding."""
    if model.deploy:
        return model
    p = next(model.parameters())
    out = RepVGG(model.num_blocks, model.width_a, model.width_b, model.num_classes,
                 deploy=True, dtype=model.dtype).to(p.device)
    fused = dict(model.blocks())
    for name, block in out.blocks():
        k, b = fused_weights(fused[name])
        block.rbr_reparam.weight.copy_(k)
        block.rbr_reparam.bias.copy_(b)
    out.linear = copy.deepcopy(model.linear)
    return out.eval()


def repvgg_A0(**kw):
    kw.pop("bn", None)
    return RepVGG(num_blocks=(2, 4, 14, 1), width_a=0.75, width_b=2.5, **kw)


def repvgg_B3(**kw):
    kw.pop("bn", None)
    return RepVGG(num_blocks=(4, 6, 16, 1), width_a=3.0, width_b=5.0, **kw)
