"""Validation heatmaps for the trainer's ``--visualize``.

Mirror of ``valle_tpu/models/visualizer.py`` (reference
``valle/models/visualizer.py:26-106``): for each of the first ``limit``
utterances of a batch, ``{output_dir}/{utt_id}.png`` with the encoder
output, the model's output (predicted mel, or codes) and the target
features, one above the other. Needs matplotlib; without it ``visualize``
raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np


def require_matplotlib():
    """The ``matplotlib.pyplot`` module on the Agg backend, or an
    ImportError that says what needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--visualize writes PNGs with matplotlib, which "
                          "is not installed here; install it or run "
                          "without --visualize") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def visualize(predicts: Tuple, batch: Dict[str, Union[List, np.ndarray]],
              output_dir: str, limit: int = 4) -> None:
    """predicts: (encoder output (B, S, d) or (B, S), model output (B, T,
    C)); batch: the loader's dict (``utt_id``, ``text_tokens_lens``,
    ``audio_features``, ``audio_features_lens``)."""
    plt = require_matplotlib()
    text_outputs, audio_outputs = (_numpy(p) for p in predicts)
    x_lens = _numpy(batch["text_tokens_lens"])
    y_lens = _numpy(batch["audio_features_lens"])
    features = _numpy(batch["audio_features"])

    for b, utt_id in enumerate(batch["utt_id"][:limit]):
        _, axes = plt.subplots(3, 1, figsize=(14, 8))
        S, T = int(x_lens[b]), int(y_lens[b])
        enc = (text_outputs[b, :S].T if text_outputs.ndim == 3
               else text_outputs[b][None, :S])
        panels = ((enc, f"{utt_id} encoder output"),
                  (audio_outputs[b, :T].T, "decoder output"),
                  (features[b, :T].T, "target features"))
        for ax, (img, title) in zip(axes, panels):
            ax.imshow(np.asarray(img, np.float32), aspect="auto",
                      origin="lower", interpolation="none")
            ax.set_title(title)
        plt.tight_layout()
        plt.savefig(f"{output_dir}/{utt_id}.png", dpi=80)
        plt.close()
