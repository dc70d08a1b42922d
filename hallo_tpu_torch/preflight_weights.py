"""Preflight of the reference checkpoints (counterpart of
scripts/preflight_weights.py):

    python -m hallo_tpu_torch.preflight_weights [--root pretrained_models]

For each checkpoint under the reference's `pretrained_models/` layout, the
file's keys and shapes are checked against the inventories
(`convert/weight_inventory.py`): every contract key is present with its
shape, and the file holds no other key. A renamed key or a truncated
download is named before a render is attempted. Without weights it prints
"missing" per file and exits 0; with weights, it exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

from hallo_tpu_torch.convert import weight_inventory as wi
from hallo_tpu_torch.convert.checkpoint_io import load_any
from hallo_tpu_torch.convert.load_pretrained import _wav2vec_key


def check(inventory, state_dict, ignore_prefixes: Sequence[str] = ()) -> List[str]:
    """The differences between a loaded state dict and an inventory."""
    issues = []
    sd_keys = {k: tuple(v.shape) for k, v in state_dict.items()
               if not any(k.startswith(p) for p in ignore_prefixes)}
    for k, shape in inventory.items():
        if k not in sd_keys:
            issues.append(f"checkpoint missing key: {k}")
        elif sd_keys[k] != tuple(shape):
            issues.append(f"shape drift at {k}: file {sd_keys[k]} vs contract {tuple(shape)}")
    issues += [f"unexpected key in file: {k}" for k in sd_keys if k not in inventory]
    return issues


def assets(root: str):
    """(name, path, inventory function, ignored key prefixes) per file."""
    w2v_dir = os.path.join(root, "wav2vec", "wav2vec2-base-960h")
    w2v = next((p for p in (os.path.join(w2v_dir, "model.safetensors"),
                            os.path.join(w2v_dir, "pytorch_model.bin")) if os.path.exists(p)),
               os.path.join(w2v_dir, "model.safetensors"))
    return [
        ("sd15_unet", os.path.join(root, "stable-diffusion-v1-5", "unet",
                                   "diffusion_pytorch_model.safetensors"),
         wi.sd15_unet_inventory, ()),
        ("sd_vae_ft_mse", os.path.join(root, "sd-vae-ft-mse",
                                       "diffusion_pytorch_model.safetensors"),
         wi.sd_vae_inventory, ()),
        ("animatediff_mm", os.path.join(root, "motion_module", "mm_sd_v15_v2.ckpt"),
         wi.animatediff_mm_inventory, ()),
        ("net_pth", os.path.join(root, "hallo", "net.pth"), wi.net_pth_inventory, ()),
        # the published file may carry the CTC head: the loader skips it
        ("wav2vec2", w2v, wi.wav2vec2_inventory, ("lm_head.",)),
    ]


def preflight(root: str) -> Dict[str, dict]:
    report = {}
    for name, path, inv_fn, ignore in assets(root):
        if not os.path.exists(path):
            report[name] = {"status": "missing", "path": path}
            continue
        try:
            sd = load_any(path)
            if name == "wav2vec2":
                sd = {_wav2vec_key(k): v for k, v in sd.items()}
            issues = check(inv_fn(), sd, ignore)
        except Exception as e:  # noqa: BLE001 — a preflight reports, it does not crash
            issues = [f"load error: {e!r}"]
        if issues:
            report[name] = {"status": "FAIL", "path": path, "issues": issues[:20],
                            "issue_count": len(issues)}
        else:
            report[name] = {"status": "ok", "path": path, "keys": len(inv_fn())}
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="pretrained_models")
    args = ap.parse_args(argv)
    report = preflight(args.root)
    print(json.dumps({"metric": "weights_preflight", "assets": report}, indent=1))
    return 1 if any(r["status"] == "FAIL" for r in report.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
