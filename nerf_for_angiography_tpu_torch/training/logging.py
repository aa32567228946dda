"""Experiment logging with the reference's TensorBoard contract (port of
``nerf_for_angiography_tpu/training/logging.py``).

Tag names, custom-scalar layout and image panels match run_nerf_acc.py
(layout :217-224; train scalars/images every 100 iters :310-320; test
scalars/images every display_every*2 :403-413). Backed by tensorboardX
where it is installed; without it the logger writes nothing, as the JAX
package's does.
"""

from __future__ import annotations

import numpy as np

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None

REFERENCE_LAYOUT = {
    "ABCDE": {
        "mean": ["Multiline", ["mean/train", "mean/train-pred"]],
        "loss": ["Multiline", ["loss/train", "loss/test"]],
        "psnr": ["Multiline", ["psnr/train", "psnr/test"]],
    },
}


class ExperimentLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.writer = SummaryWriter(log_dir=log_dir) if SummaryWriter else None
        if self.writer:
            self.writer.add_custom_scalars(REFERENCE_LAYOUT)

    def scalars(self, metrics: dict, step: int) -> None:
        if not self.writer:
            return
        for tag, value in metrics.items():
            self.writer.add_scalar(tag, float(value), step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        if not self.writer:
            return
        self.writer.add_image(tag, np.asarray(img), step, dataformats="HW")

    def train_images(self, pred: np.ndarray, target: np.ndarray, step: int) -> None:
        """Pred/Orig/Diff panels (run_nerf_acc.py:316-320)."""
        self.image("Pred/train-pred-coarse", pred, step)
        self.image("Orig/train", target, step)
        self.image("Diff/train-diff-coarse", np.abs(pred - target), step)

    def test_images(self, pred: np.ndarray, target: np.ndarray, step: int) -> None:
        """Test panels (run_nerf_acc.py:411-413)."""
        self.image("Pred/coarse-test-pred", pred, step)
        self.image("Orig/test", target, step)
        self.image("Diff/coarse-test-diff", np.abs(pred - target), step)

    def close(self) -> None:
        if self.writer:
            self.writer.close()
