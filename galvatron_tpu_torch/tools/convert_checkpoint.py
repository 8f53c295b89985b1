"""HF <-> the port's checkpoint converters.

Port of ``galvatron_tpu/tools/convert_checkpoint.py`` (after the upstream
``checkpoint_convert_h2g.py`` / ``_g2h.py``): h2g reads a HuggingFace
checkpoint (a model directory with its ``config.json``, a torch ``.bin`` /
``.pt`` file or a ``.safetensors`` file; ``models.hf_utils``, which needs
neither ``transformers`` nor ``safetensors``), turns it into the family's
tree and writes it as a params-only step 0 in the port's checkpoint format:
rank files, the integrity manifest and its provenance, with ``train_meta``
``{"iteration": 0, "source": "hf", "model_type": ...}``. The step is
written at world 1 (every tensor whole), so ``cli train --load`` shards it
into any strategy and world size, with a fresh optimizer, and ``cli serve
--load`` serves it. g2h reads any port checkpoint back (every rank's shards
assembled: ``runtime.checkpoint.load_full_params``) into an HF state dict
saved as a torch ``.bin`` of fp32 tensors.

CLI:
  python -m galvatron_tpu_torch.tools.convert_checkpoint h2g \\
      --model_type llama --hf_path <dir|file.bin|file.safetensors> --output_dir ckpt/
  python -m galvatron_tpu_torch.tools.convert_checkpoint g2h \\
      --model_type llama --hf_config_path <dir|config.json> --checkpoint_dir ckpt/ \\
      --output_path out.bin
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from galvatron_tpu_torch.models.hf_utils import load_hf_state_dict, read_hf_config
from galvatron_tpu_torch.models.registry import get_family


def hf_to_native(model_type: str, hf_state_dict: Dict[str, Any], hf_config=None,
                 model_size: Optional[str] = None, **config_overrides):
    """(cfg, the port's state dict). `hf_config` (a config namespace,
    `models.hf_utils.read_hf_config`) wins over the `model_size` preset."""
    fam = get_family(model_type)
    if fam.convert_from_hf is None:
        raise NotImplementedError("family %r has no HF converter" % model_type)
    if hf_config is not None:
        cfg = fam.config_from_hf(hf_config, **config_overrides)
    else:
        cfg = fam.config_fn(model_size or fam.default_size, **config_overrides)
    return cfg, fam.convert_from_hf(hf_state_dict, cfg)


def native_to_hf(model_type: str, params, cfg) -> Dict[str, np.ndarray]:
    fam = get_family(model_type)
    if fam.export_to_hf is None:
        raise NotImplementedError("family %r has no HF exporter" % model_type)
    return fam.export_to_hf(params, cfg)


def _config(fam, hf_config_path: Optional[str], model_size: Optional[str]):
    if hf_config_path:
        return fam.config_from_hf(read_hf_config(hf_config_path, fam.name))
    return fam.config_fn(model_size or fam.default_size)


def convert_h2g(args) -> str:
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.runtime.checkpoint import save_checkpoint
    from galvatron_tpu_torch.runtime.provenance import build_provenance, model_config_fields

    sd = load_hf_state_dict(args.hf_path)
    fam = get_family(args.model_type)
    hf_config = None
    if args.hf_config_path or os.path.isdir(args.hf_path):
        hf_config = read_hf_config(args.hf_config_path or args.hf_path, fam.name)
    cfg, params = hf_to_native(args.model_type, sd, hf_config=hf_config,
                               model_size=args.model_size)
    del sd
    hp = HybridParallelConfig.uniform(1, cfg.num_layers, global_bsz=1)
    save_checkpoint(args.output_dir, 0, params, hp=hp,
                    train_meta={"iteration": 0, "source": "hf", "model_type": args.model_type},
                    provenance=build_provenance(hp, cfg),
                    meta={"model_type": args.model_type, "model_size": args.model_size,
                          "model_config": model_config_fields(cfg)})
    return args.output_dir


def convert_g2h(args) -> str:
    from galvatron_tpu_torch.runtime.checkpoint import load_full_params

    fam = get_family(args.model_type)
    cfg = _config(fam, args.hf_config_path, args.model_size)
    params, _ = load_full_params(args.checkpoint_dir, args.iteration, cfg, strict_model=False)
    sd = native_to_hf(args.model_type, params, cfg)
    del params
    torch.save({k: torch.from_numpy(v).contiguous() for k, v in sd.items()}, args.output_path)
    return args.output_path


def main(argv=None):
    p = argparse.ArgumentParser("galvatron_tpu_torch checkpoint converter")
    sub = p.add_subparsers(dest="direction", required=True)
    h2g = sub.add_parser("h2g", help="HuggingFace -> the port's checkpoint (params only)")
    h2g.add_argument("--model_type", required=True)
    h2g.add_argument("--model_size", default=None)
    h2g.add_argument("--hf_path", required=True)
    h2g.add_argument("--hf_config_path", default=None)
    h2g.add_argument("--output_dir", required=True)
    g2h = sub.add_parser("g2h", help="the port's checkpoint -> HF state dict (.bin)")
    g2h.add_argument("--model_type", required=True)
    g2h.add_argument("--model_size", default=None)
    g2h.add_argument("--hf_config_path", default=None)
    g2h.add_argument("--checkpoint_dir", required=True)
    g2h.add_argument("--iteration", type=int, default=None)
    g2h.add_argument("--output_path", required=True)
    args = p.parse_args(argv)
    out = convert_h2g(args) if args.direction == "h2g" else convert_g2h(args)
    print("wrote %s" % out)
    return out


if __name__ == "__main__":
    main()
