"""CLI: CLIP zero-shot classification weights from a raw checkpoint.

Counterpart of ``robustart_tpu/tools/clip_zero_shot.py``. A raw OpenAI
``ViT-L-14.pt`` holds both towers and no classifier: this runs the
checkpoint's own text tower over the 80-prompt ImageNet ensemble
(``models/clip_text.py``) and writes the ``(embed_dim, n_classes)`` head as
``.npz``:

    python -m robustart_torch.tools.clip_zero_shot \\
        --ckpt ViT-L-14.pt --classnames imagenet_classnames.txt \\
        --bpe bpe_simple_vocab_16e6.txt.gz --out zero_shot_weights.npz

Then point ``saver.pretrain.clip_zero_shot.weights`` at the npz, or skip
this CLI and give ``saver.pretrain.clip_zero_shot.{classnames,bpe}``: the
loader computes it inline (``models/convert.py::load_clip_zero_shot``). The
text tower runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help="raw OpenAI CLIP .pt")
    ap.add_argument("--classnames", required=True, help="text file, one class name per line")
    ap.add_argument("--bpe", required=True,
                    help="CLIP BPE merges (bpe_simple_vocab_16e6.txt.gz)")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--templates", default="",
                    help="optional file of prompt templates ({} = class); default: the "
                         "80-prompt OpenAI ensemble")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the text tower (default cuda)")
    args = ap.parse_args(argv)

    from robustart_torch.models.clip_text import (OPENAI_IMAGENET_TEMPLATES, SimpleTokenizer,
                                                  compute_zero_shot_weights)
    from robustart_torch.models.convert import read_torch_checkpoint

    with open(args.classnames) as f:
        classnames = [ln.strip() for ln in f if ln.strip()]
    templates = OPENAI_IMAGENET_TEMPLATES
    if args.templates:
        with open(args.templates) as f:
            templates = tuple(ln.rstrip("\n") for ln in f if ln.strip())
    w = compute_zero_shot_weights(read_torch_checkpoint(args.ckpt), classnames,
                                  templates=templates, tokenizer=SimpleTokenizer(args.bpe),
                                  device=args.device)
    np.savez(args.out, zero_shot_weights=w)
    print(f"wrote {args.out}: {w.shape} ({len(classnames)} classes, "
          f"{len(templates)} templates)")


if __name__ == "__main__":
    main()
