"""DenseNet 121/169/201.

Counterpart of ``robustart_tpu/models/densenet.py``. Module names follow
torchvision (``features.conv0``, ``features.norm0``,
``features.denseblockB.denselayerL.{norm1, conv1, norm2, conv2}``,
``features.transitionB.{norm, conv}``, ``features.norm5``, ``classifier``),
so a torchvision checkpoint loads as it is and ``models/convert.py`` maps the
JAX package's variables onto the same keys. BatchNorm eps is 1e-5.

Two forwards, both eval only, on normalized NHWC images:

- on the CPU, :meth:`DenseNet.concat_forward`: BN-ReLU-1×1-BN-ReLU-3×3 per
  layer with the concatenation rebuilt each layer, the Flax module's
  ``concat`` form;
- on CUDA, :meth:`DenseNet.fused_forward`, the mirror of the JAX package's
  ``fused_eval_forward`` (:268-339): every dense block is one call of K12
  (``ops/densenet.py::dense_block``), its BatchNorms folded and its weights
  packed once and reused while every parameter and statistic of the block is
  the same tensor at the same version, so a checkpoint loaded or a weight
  changed in place at any time takes effect at the next forward. The stem, the transitions
  (folded BN, ReLU, 1×1, 2×2 average pool), ``norm5`` and the head stay
  cuDNN and torch, as the JAX package leaves them to XLA.

The JAX module's ``slab_eval_forward`` and its ``concat_impl`` choices are
workarounds of the TPU's compiler and are not ported (ROADMAP.md).

``dtype=torch.bfloat16`` keeps the convolution weights in bf16 and computes
there; BatchNorm parameters and statistics and the classifier stay float32,
and the classifier runs in float32 on the pooled features.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.layers import MaxPool2d, full_f32, global_avg_pool
from robustart_torch.ops.densenet import dense_block, fold_bn, pack_w1t, pack_w2t

BN_EPS = 1e-5


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval BatchNorm of NCHW x with the f32 parameters, in x's type."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        False, 0.0, bn.eps).to(x.dtype)


def _affine_relu(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """relu(x·inv + shift) over the last axis of NHWC x, the folded BN cast
    to x's type (``fused_eval_forward``'s ``relu(x * a.astype(dt) + b.astype(dt))``)."""
    a, b = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return torch.relu(x * a.to(x.dtype) + b.to(x.dtype))


class DenseLayer(nn.Module):
    def __init__(self, in_chans: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = nn.BatchNorm2d(in_chans, eps=BN_EPS)
        self.conv1 = nn.Conv2d(in_chans, mid, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(mid, eps=BN_EPS)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The g new channels of NCHW x."""
        out = self.conv1(F.relu(_bn(x, self.norm1)))
        return self.conv2(F.relu(_bn(out, self.norm2)))


class Transition(nn.Module):
    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_chans, eps=BN_EPS)
        self.conv = nn.Conv2d(in_chans, out_chans, 1, bias=False)


class DenseNet(nn.Module):
    """DenseNet on normalized NHWC images → (N, num_classes) float32 logits."""

    def __init__(self, block_config: Sequence[int], growth_rate: int = 32,
                 num_init_features: int = 64, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.block_config = tuple(block_config)
        self.growth_rate = growth_rate
        self.mid = 4 * growth_rate
        feats: OrderedDict[str, nn.Module] = OrderedDict(
            conv0=nn.Conv2d(3, num_init_features, 7, 2, 3, bias=False),
            norm0=nn.BatchNorm2d(num_init_features, eps=BN_EPS),
        )
        c = num_init_features
        for bi, n_layers in enumerate(self.block_config):
            feats[f"denseblock{bi + 1}"] = nn.ModuleDict({
                f"denselayer{li + 1}": DenseLayer(c + li * growth_rate, growth_rate)
                for li in range(n_layers)
            })
            c += n_layers * growth_rate
            if bi != len(self.block_config) - 1:
                feats[f"transition{bi + 1}"] = Transition(c, c // 2)
                c //= 2
        feats["norm5"] = nn.BatchNorm2d(c, eps=BN_EPS)
        self.features = nn.Sequential(feats)
        self.classifier = nn.Linear(c, num_classes)
        self.pool = MaxPool2d()
        # dense block index: (the sources' (data_ptr, _version), the packed parameters)
        self._pack_cache: dict[int, tuple] = {}
        self.to(memory_format=torch.channels_last)
        for m in self.features.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.data = m.weight.data.to(dtype)

    def _blocks(self):
        for bi in range(len(self.block_config)):
            last = bi == len(self.block_config) - 1
            yield (getattr(self.features, f"denseblock{bi + 1}"),
                   None if last else getattr(self.features, f"transition{bi + 1}"))

    def _precision(self):
        return full_f32() if self.dtype == torch.float32 else contextlib.nullcontext()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits: K12 in
        every dense block on CUDA, the concat forward on the CPU."""
        if self.training:
            raise NotImplementedError("training is not ported (ROADMAP.md, modules to port: "
                                      "Training)")
        if x.device.type == "cpu":
            return self.concat_forward(x)
        return self.fused_forward(x)

    def concat_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The module forward: each layer's new channels concatenated."""
        f = self.features
        with self._precision():
            # an NHWC tensor seen through permute is NCHW with channels_last strides
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            x = self.pool(F.relu(_bn(f.conv0(x), f.norm0)))
            for block, trans in self._blocks():
                for layer in block.values():
                    x = torch.cat([x, layer(x)], dim=1)
                if trans is not None:
                    x = F.avg_pool2d(trans.conv(F.relu(_bn(x, trans.norm))), 2)
            x = global_avg_pool(F.relu(_bn(x, f.norm5))).float()
            return self.classifier(x)

    def packed_block(self, block: nn.ModuleDict) -> tuple:
        """(g1, b1, w1, g2, b2, w2) of a dense block for K12, folded and
        packed from the current parameters as ``fused_eval_forward`` packs
        them: affines f32, W1 (S, mid) and W2 (L·9·mid, g) in the model's
        type."""
        layers = list(block.values())

        def folded(norms):
            return fold_bn(*(torch.cat([getattr(n, k) for n in norms])
                             for k in ("weight", "bias", "running_mean", "running_var")), BN_EPS)

        g1, b1 = folded([l.norm1 for l in layers])
        g2, b2 = folded([l.norm2 for l in layers])
        w1 = torch.cat([l.conv1.weight.reshape(self.mid, -1).t() for l in layers])
        # OIHW → (ky, kx, mid) rows × g columns
        w2 = torch.cat([l.conv2.weight.permute(2, 3, 1, 0).reshape(9 * self.mid, -1)
                        for l in layers])
        n = len(layers)
        return (g1[None], b1[None], w1.to(self.dtype), g2.reshape(n, self.mid),
                b2.reshape(n, self.mid), w2.to(self.dtype))

    def packed(self, bi: int, block: nn.ModuleDict) -> tuple:
        """(:meth:`packed_block`, the kernels' transposes) of dense block
        ``bi``: in bf16 ``{"w1t", "w2t"}`` (``ops/densenet.py::pack_w1t``,
        ``pack_w2t``), the layouts of the 1×1 product and the 3×3; in f32
        none. Packed once and reused while every parameter
        and buffer of the block's layers is the same tensor at the same
        version (``data_ptr``, ``_version``), so a state dict loaded or a
        weight changed in place packs anew. A tensor made under
        ``torch.inference_mode`` has no version counter, so a block holding
        one is packed at every call. The cached pack is made outside
        inference mode and without autograd history, so that a forward that
        needs the input's gradient (an attack, where K12's gradient is its
        plain version's) may save it for the backward whichever mode packed
        it. A gradient for the block's parameters is refused: the pack
        would not carry it."""
        sources = [t for layer in block.values() for t in (*layer.parameters(), *layer.buffers())]
        if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
            raise RuntimeError("parameter gradients through the DenseNet are not ported "
                               "(ROADMAP.md, modules to port: Training); freeze the model "
                               "with requires_grad_(False)")
        key = (None if any(t.is_inference() for t in sources)
               else tuple((t.data_ptr(), t._version) for t in sources))
        hit = self._pack_cache.get(bi)
        if key is None or hit is None or hit[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                hit = self._pack_cache[bi] = (key, self._pack(block))
        return hit[1]

    def _pack(self, block: nn.ModuleDict) -> tuple:
        params = self.packed_block(block)
        shape = dict(growth=self.growth_rate, n_layers=len(block), mid=self.mid)
        transposes = ({"w1t": pack_w1t(params[2], c0=block["denselayer1"].norm1.num_features,
                                       **shape),
                       "w2t": pack_w2t(params[5], **shape)}
                      if self.dtype == torch.bfloat16 else {})
        return params, transposes

    def fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's ``fused_eval_forward``: K12 for every dense
        block (on a CPU tensor, its plain version), on the cached pack."""
        f, dt = self.features, self.dtype
        with self._precision():
            x = f.conv0(x.to(dt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            x = self.pool(_affine_relu(x, f.norm0).permute(0, 3, 1, 2))
            x = x.permute(0, 2, 3, 1).contiguous()
            for bi, (block, trans) in enumerate(self._blocks()):
                params, transposes = self.packed(bi, block)
                x = dense_block(x, *params, c0=x.shape[-1], growth=self.growth_rate,
                                n_layers=len(block), mid=self.mid, **transposes)
                if trans is not None:
                    y = trans.conv(_affine_relu(x, trans.norm).permute(0, 3, 1, 2))
                    x = F.avg_pool2d(y, 2).permute(0, 2, 3, 1).contiguous()
            x = _affine_relu(x, f.norm5).mean(dim=(1, 2)).float()
            return self.classifier(x)


@torch.no_grad()
def jitter_batch_norms(model: DenseNet, generator: torch.Generator) -> None:
    """BatchNorm parameters and statistics away from identity (tests and
    smoke checks only): weight U(0.5, 1.5), bias N(0, 0.1), running mean
    N(0, 0.1), running variance U(0.5, 2), so that folding them is not
    trivial (``tests/test_pallas_densenet.py`` jitters them the same way)."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
            m.bias.copy_(torch.randn(n, generator=generator) * 0.1)
            m.running_mean.copy_(torch.randn(n, generator=generator) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=generator) * 1.5 + 0.5)


def densenet121(**kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: eval uses running stats
    return DenseNet(block_config=(6, 12, 24, 16), **kw)


def densenet169(**kw):
    kw.pop("bn", None)
    return DenseNet(block_config=(6, 12, 32, 32), **kw)


def densenet201(**kw):
    kw.pop("bn", None)
    return DenseNet(block_config=(6, 12, 48, 32), **kw)
