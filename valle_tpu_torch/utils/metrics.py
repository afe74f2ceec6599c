"""Training metrics accumulation.

Mirror of ``valle_tpu/utils/metrics.py`` (icefall's ``MetricsTracker`` as
the reference trainer uses it, ``valle/bin/trainer.py:535-570``): a
dict of sums with ``+``, scaling, printing normalized by frame count and
TensorBoard writing. ``reduce`` sums across data-parallel ranks with
``torch.distributed``.
"""

from __future__ import annotations

from collections import defaultdict


class MetricsTracker(defaultdict):
    def __init__(self):
        super().__init__(float)

    def __add__(self, other: "MetricsTracker") -> "MetricsTracker":
        ans = MetricsTracker()
        for k, v in self.items():
            ans[k] = v
        for k, v in other.items():
            ans[k] = ans[k] + v
        return ans

    def __mul__(self, alpha: float) -> "MetricsTracker":
        ans = MetricsTracker()
        for k, v in self.items():
            ans[k] = v * alpha
        return ans

    def __str__(self) -> str:
        ans = ""
        for k, v in self.norm_items():
            norm_value = "%.4g" % v
            ans += str(k) + "=" + str(norm_value) + ", "
        frames = "%.2f" % self["frames"]
        ans += "over " + str(frames) + " frames."
        return ans

    def norm_items(self):
        """Yield (key, normalized_value): losses/metrics divided by frames
        (``utt_*`` keys by utterances). Guards frames/utterances == 0
        (e.g. an empty validation loader) instead of dividing by zero."""
        num_frames = max(self["frames"], 1) if "frames" in self else 1
        num_utterances = (max(self["utterances"], 1)
                          if "utterances" in self else 1)
        for k, v in self.items():
            if k in ("frames", "utterances"):
                continue
            norm_value = (
                float(v) / num_frames
                if "utt_" not in k
                else float(v) / num_utterances
            )
            yield k, norm_value

    def reduce(self, group=None) -> "MetricsTracker":
        """Sum every value over the data-parallel ranks, in place (every
        rank calls it with the same keys): one ``all_reduce`` of a CPU
        float64 vector over ``group``, a gloo group (None: the default
        one). A no-op without a process group of several ranks."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size(group) > 1):
            return self
        keys = sorted(self.keys())
        vals = torch.tensor([float(self[k]) for k in keys],
                            dtype=torch.float64)
        dist.all_reduce(vals, group=group)
        for k, v in zip(keys, vals.tolist()):
            self[k] = v
        return self

    def write_summary(self, tb_writer, prefix: str, batch_idx: int) -> None:
        for k, v in self.norm_items():
            tb_writer.add_scalar(prefix + k, v, batch_idx)
