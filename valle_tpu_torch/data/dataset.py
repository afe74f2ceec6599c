"""Speech-synthesis dataset: cuts -> model-ready numpy batches.

A host-side copy of ``valle_tpu/data/dataset.py`` (numpy; the batch
becomes tensors in the trainer's main thread).

Parity with reference ``valle/data/dataset.py`` (``SpeechSynthesisDataset``,
:33-111): a batch dict with utt_id, raw text, audio features (B, T, Q) +
lens, text tokens (B, L) + lens; text tokens come from the offline
tokenization stored on the cut (reference reads
``cut.supervisions[0].custom['tokens']['text']``, :91 — here ``cut.tokens``).

Optional ``pad_audio_to``/``pad_text_to`` targets let the bucketing
batcher emit a bounded set of shapes (the JAX package's static-shape
rule, kept so both packages see the same batches).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .collation import TextTokenCollater
from .input_strategies import PrecomputedFeatures, PromptedFeatures


class SpeechSynthesisDataset:
    def __init__(
        self,
        text_token_collater: TextTokenCollater,
        feature_input_strategy=None,
        feature_transforms: Optional[List[Callable]] = None,
        cut_transforms: Optional[List[Callable]] = None,
    ) -> None:
        self.text_token_collater = text_token_collater
        self.feature_input_strategy = (feature_input_strategy
                                       or PrecomputedFeatures())
        self.feature_transforms = feature_transforms or []
        self.cut_transforms = cut_transforms or []

    def __getitem__(self, cuts, pad_audio_to: int = 0,
                    pad_text_to: int = 0) -> Dict:
        for t in self.cut_transforms:
            cuts = t(cuts)

        for cut in cuts:
            assert cut.tokens is not None, (
                f"cut {cut.id} has no text tokens; run the offline "
                f"tokenizer first")

        features = self.feature_input_strategy(cuts)
        if isinstance(features, tuple):
            audio_features, audio_features_lens = features
        else:
            audio_features, audio_features_lens = features, None

        if isinstance(audio_features, PromptedFeatures):
            # bounded shapes: pad the prompts to the 3 s-cap grid
            # (mini_frames varies per batch otherwise) and the features
            # to the sampler's bucket shape
            prompts, feats = audio_features.data
            PP = 240  # >= 225 (3 s at 75 Hz); one static prompt shape
            if prompts.shape[1] < PP:
                prompts = np.pad(
                    prompts, ((0, 0), (0, PP - prompts.shape[1]), (0, 0)))
            if pad_audio_to and feats.shape[1] < pad_audio_to:
                feats = np.pad(
                    feats,
                    ((0, 0), (0, pad_audio_to - feats.shape[1]), (0, 0)))
            audio_features = PromptedFeatures(prompts, feats)
        else:
            for t in self.feature_transforms:
                try:  # length-aware transforms mask only valid frames
                    audio_features = t(audio_features,
                                       audio_features_lens)
                except TypeError:
                    audio_features = t(audio_features)
            if pad_audio_to and audio_features.shape[1] < pad_audio_to:
                pad = pad_audio_to - audio_features.shape[1]
                audio_features = np.pad(
                    audio_features, ((0, 0), (0, pad), (0, 0)))

        text_tokens, text_tokens_lens = self.text_token_collater.index(
            [cut.tokens for cut in cuts], pad_to=pad_text_to)

        return {
            "utt_id": [cut.id for cut in cuts],
            "text": [cut.text for cut in cuts],
            "audio": None,  # raw audio not returned (reference :80-83)
            "audio_lens": None,
            "audio_features": audio_features,
            "audio_features_lens": audio_features_lens,
            "text_tokens": text_tokens,
            "text_tokens_lens": text_tokens_lens,
        }
