"""Train a small LM end to end on the synthetic Markov pipeline with
checkpointing and restart, through the PyTorch port's launcher, after
``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py              # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --arch xlstm-350m --steps 20

The checkpoints go to ``--ckpt-dir`` (default: a directory of that name
under the system's temporary directory); a second run with the same
directory resumes from its last checkpoint.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args()
    train_main(["--arch", args.arch, "--smoke", "--steps", str(args.steps),
                "--batch", "8", "--seq", "64", "--lr", "1e-2",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "40",
                "--device", args.device])
