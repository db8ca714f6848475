"""Convert a DenseCap .t7 checkpoint into the shared params .npz (twin of
densecap_tpu/cli/convert_t7.py, with the same flags and output).

    python -m densecap_tpu_torch.cli.convert_t7 --t7 densecap-pretrained.t7 \\
        --output pretrained.npz

Reads the torch checkpoint with the port's pure-python t7 reader
(`utils.t7_reader`) and converts every learned tensor: the 13 VGG convs
and fc6/fc7, the RPN conv stack, the final objectness / box-regression
linears and the whole language model (image encoder, lookup table,
torch-rnn LSTM, vocab projection). The `.npz` holds the JAX package's
layout, so the port (`utils.checkpoint.load_checkpoint`) and the JAX
package both load it; its meta `config` is this package's
`DenseCapConfig.to_json`.

With --vgg_only only the VGG trunk and fc6/fc7 are taken, and the RPN,
branches and language model come fresh from `utils.checkpoint
.init_params(cfg, --seed)` (the start state the reference trains from);
--vocab_size is then required, and no vocabulary is written.
"""

from __future__ import annotations

import argparse
import json

from ..config import DenseCapConfig
from ..utils import checkpoint as ckpt
from ..utils import t7_reader


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--t7", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--vgg_only", action="store_true",
                   help="take only VGG weights; fresh RPN/branches/LM")
    p.add_argument("--vocab_size", type=int, default=None,
                   help="required with --vgg_only; otherwise derived "
                        "from the checkpoint's lookup table")
    p.add_argument("--seq_length", type=int, default=15)
    p.add_argument("--anchor_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)

    print(f"reading {args.t7} ...")
    loaded = t7_reader.load(args.t7)

    if args.vgg_only:
        if args.vocab_size is None:
            p.error("--vgg_only requires --vocab_size")
        weights = t7_reader.extract_densecap_weights(loaded)
        print(f"extracted {len(weights)} tensors (VGG only)")
        trunk1, trunk2, recog = ckpt.convert_torch_vgg16(weights)
        cfg = DenseCapConfig(vocab_size=args.vocab_size,
                             seq_length=args.seq_length,
                             anchor_scale=args.anchor_scale)
        params = ckpt.init_params(cfg, seed=args.seed)
        params["trunk1"] = trunk1
        params["trunk2"] = trunk2
        params["recog"] = recog
        note = "VGG trunk+recog from t7; RPN/branches/LM fresh"
    else:
        weights = t7_reader.extract_full_densecap_weights(loaded)
        print(f"extracted {len(weights)} tensors (full checkpoint)")
        params, info = ckpt.convert_torch_densecap(weights)
        print(f"derived dims: {info}")
        cfg = DenseCapConfig(
            vocab_size=info["vocab_size"],
            seq_length=args.seq_length,
            rpn_num_filters=info["rpn_num_filters"],
            rnn_size=info["rnn_size"],
            rnn_encoding_size=info["rnn_encoding_size"],
            fc_dim=info["fc_dim"],
            anchor_scale=args.anchor_scale,
        )
        if info["num_anchors"] != cfg.num_anchors:
            raise SystemExit(
                f"checkpoint has {info['num_anchors']} anchors but the "
                f"config defines {cfg.num_anchors}; pass matching "
                f"anchors via config")
        note = "full pretrained conversion (VGG+RPN+branches+LM)"

    # the checkpoint's vocabulary belongs to its language model: with
    # --vgg_only the LM is fresh, for a vocab_size the user chose, so the
    # pretrained tokens would decode as unrelated words
    idx_to_token = ({} if args.vgg_only
                    else t7_reader.extract_idx_to_token(loaded))
    if idx_to_token:
        print(f"vocabulary: {len(idx_to_token)} tokens")
    meta = json.dumps({
        "vocab_size": cfg.vocab_size,
        "seq_length": cfg.seq_length,
        "config": cfg.to_json(),
        "idx_to_token": {str(k): v for k, v in idx_to_token.items()},
        "note": note,
    })
    ckpt.save_params(args.output, params, extra={"meta": meta})
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
