"""End-to-end training on the PyTorch port: train a small LM (MiniCPM-2B
reduced) for a few hundred steps with checkpointing and auto-resume, and
show the loss falling.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 200]
        [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    args = ap.parse_args(argv)
    train_args = ["--arch", "minicpm_2b", "--reduced",
                  "--steps", str(args.steps), "--batch", "8", "--seq", "64",
                  "--schedule", "wsd", "--ckpt-dir", args.ckpt_dir,
                  "--ckpt-every", "100"]
    if args.device:
        train_args += ["--device", args.device]
    losses = train_main(train_args)
    assert losses[-1] < losses[0], "loss should fall"
    print("OK: loss fell from %.3f to %.3f" % (losses[0], losses[-1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
