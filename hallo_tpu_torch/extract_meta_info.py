"""Stage-1 and stage-2 meta JSON from the builder's clips (counterpart of
scripts/extract_meta_info.py; reference scripts/extract_meta_info_stage1.py
and _stage2.py):

    python -m hallo_tpu_torch.extract_meta_info -i data/clips --stage 2 \
        -o data/dataset_stage2.json

A clip without frames or a face embedding is skipped, and at stage 2 one
without an audio embedding, or whose frame and audio counts differ by more
than 3 (extract_meta_info_stage2.py:128-132). Host code only.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

# The most frames and audio embeddings of one clip may differ by.
MAX_FRAME_AUDIO_GAP = 3


def main(argv=None) -> list:
    """Write the meta JSON; returns its entries."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-i", "--clips_dir", required=True)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--stage", type=int, default=2, choices=(1, 2))
    args = parser.parse_args(argv)

    meta = []
    for npz in sorted(Path(args.clips_dir).glob("*.npz")):
        data = np.load(npz)
        if "frames" not in data or "face_emb" not in data:
            print(f"skip {npz.name}: missing frames/face_emb")
            continue
        if args.stage == 2:
            if "audio_emb" not in data:
                print(f"skip {npz.name}: no audio embedding")
                continue
            n_frames, n_audio = len(data["frames"]), len(data["audio_emb"])
            if abs(n_frames - n_audio) > MAX_FRAME_AUDIO_GAP:
                print(f"skip {npz.name}: frames {n_frames} vs audio {n_audio}")
                continue
        meta.append({"clip_path": str(npz)})

    out = args.output or f"./data/dataset_stage{args.stage}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {out} ({len(meta)} clips)")
    return meta


if __name__ == "__main__":
    main()
