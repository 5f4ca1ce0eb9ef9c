"""Serve a small LM with batched requests through the PyTorch port's slot
engine, after ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args()
    serve_main(["--arch", "qwen3-0.6b", "--smoke", "--requests", "6",
                "--max-new", "12", "--batch", "3", "--device", args.device])
