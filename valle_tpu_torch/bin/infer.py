#!/usr/bin/env python3
"""Zero-shot TTS inference CLI of the port (mirror of
``valle_tpu/bin/infer.py``).

``--text-prompts`` / ``--audio-prompts`` ("|"-separated pairs, phonemized
together with the target), ``--text`` targets ("|"-separated, or a TSV
file of ``prompt_text, prompt_wav, text, output_wav`` lines), the model
rebuilt from the hyperparameters a reference-format ``.pt`` checkpoint
stores, top-k / temperature sampling, ``--continual`` resynthesis and
24 kHz wav output. Runs on ``--device`` (default ``cuda``; the CLI raises
when there is no card), in fp32 with decode mode ``exact`` unless
``--decode-mode`` asks for another, as the JAX CLI does.

Example:
  python3 -m valle_tpu_torch.bin.infer --output-dir demos/ \\
      --text-prompts "KNOT one point one five miles per hour." \\
      --audio-prompts ./prompts/8463_294825_000043_000000.wav \\
      --text "To get up and running quickly just follow the steps below." \\
      --checkpoint exp/valle/epoch-100.pt \\
      --encodec-weights encodec_24khz-d7cc33bc.th
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch

from ..models import add_model_arguments, load_model
from ..utils import setup_logger, str2bool


def get_parser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--text-prompts", type=str, default="",
                        help="Text prompts separated by |.")
    parser.add_argument("--audio-prompts", type=str, default="",
                        help="Audio prompt wavs separated by |.")
    parser.add_argument("--text", type=str,
                        default="To get up and running quickly just follow "
                                "the steps below.",
                        help="Text to synthesize, | separated, or a TSV "
                             "file (batch-demo mode).")
    parser.add_argument("--language", type=str, default="en-us")
    parser.add_argument("--text-extractor", type=str, default="espeak",
                        help="espeak | pypinyin | pypinyin_initials_finals "
                             "| char (only char is ported)")
    parser.add_argument("--checkpoint", type=str,
                        default="exp/vallf_nano_full/checkpoint-100000")
    parser.add_argument("--text-tokens", type=str, default=None,
                        help="Symbol table path; defaults to the path "
                             "stored in the checkpoint, then to "
                             "data/tokenized/unique_text_tokens.k2symbols")
    parser.add_argument("--encodec-weights", type=str, default=None,
                        help="Path to pretrained EnCodec 24 kHz torch "
                             "weights (or set VALLE_TPU_ENCODEC_WEIGHTS).")
    parser.add_argument("--top-k", type=int, default=-100)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--continual", type=str2bool, default=False)
    parser.add_argument("--output-dir", type=str, default="infer/demos")
    parser.add_argument("--max-gen-len", type=int, default=1024)
    parser.add_argument("--decode-mode", type=str, default="exact",
                        help="exact | unroll | fused (the hand-written "
                             "dense kernels) | fused_w8 | int8 | "
                             "fused_int8 | bf16 | fused_kv | lanes | "
                             "fused_lanes | mega | auto; the modes that "
                             "group rows by 8 run their ungrouped "
                             "substitute at the CLI's batch 1.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda | cpu")
    add_model_arguments(parser)
    return parser


def _synthesize(model, args, text_ids, text_lens, prompt_codes, prompt_lens,
                enroll_x_lens, generator, device, *, continual=False):
    """One request through ``valle_inference`` (or, with ``continual``,
    ``valle_continual``): returns the generated codes (F, Q) numpy."""
    from ..models.inference import valle_continual, valle_inference

    dev = lambda a: torch.as_tensor(np.asarray(a), device=device)
    if continual:
        codes, out_lens = valle_continual(
            model, dev(text_ids), dev(text_lens), dev(prompt_codes),
            dev(prompt_lens))
    else:
        codes, out_lens = valle_inference(
            model, dev(text_ids), dev(text_lens), dev(prompt_codes),
            dev(prompt_lens), dev(enroll_x_lens), top_k=args.top_k,
            temperature=args.temperature, generator=generator,
            max_gen_len=args.max_gen_len, compute_dtype=torch.float32,
            decode_mode=args.decode_mode)
    return codes[0, : int(out_lens[0])].cpu().numpy()


def _enroll_lens(text_tokenizer, prompt_text: str) -> np.ndarray:
    """len(prompt phonemes) + 2; a bare 2 (the identity of
    trim_enrolled_text) without prompt text."""
    from ..data.tokenizer import tokenize_text

    n = (len(tokenize_text(text_tokenizer, prompt_text))
         if prompt_text.strip() else 0)
    return np.array([n + 2], np.int32)


def main(argv=None):
    args = get_parser().parse_args(argv)
    setup_logger()
    from .. import native
    from ..data.collation import get_text_token_collater
    from ..data.tokenizer import (AudioTokenizer, TextTokenizer,
                                  tokenize_audio, tokenize_text)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    text_tokenizer = TextTokenizer(language=args.language,
                                   backend=args.text_extractor)
    model, ckpt_tokens = load_model(args.checkpoint, args, device=device)
    Q = model.cfg.num_quantizers
    text_collater = get_text_token_collater(
        args.text_tokens or ckpt_tokens
        or "data/tokenized/unique_text_tokens.k2symbols")
    audio_tokenizer = AudioTokenizer(weights_path=args.encodec_weights,
                                     device=device)
    if not audio_tokenizer.pretrained:
        logging.warning(
            "EnCodec running with RANDOM weights (no --encodec-weights); "
            "decoded audio will not be intelligible")
    generator = torch.Generator(device).manual_seed(args.seed)

    def save(path: Path, codes: np.ndarray) -> None:
        wav = audio_tokenizer.decode(codes[None])[0]
        path.parent.mkdir(parents=True, exist_ok=True)
        native.write_wav(str(path), wav, audio_tokenizer.sample_rate)
        logging.info(f"saved {path} ({len(wav) / 24000:.2f} s, "
                     f"{codes.shape[0]} frames)")

    if os.path.isfile(args.text):  # TSV batch-demo mode
        if args.continual:
            logging.warning("--continual does not apply to a TSV file; "
                            "each line is synthesized from its text")
        with open(args.text, encoding="utf-8") as f:
            for k, line in enumerate(f):
                fields = line.strip().split("\t")
                if len(fields) != 4:
                    raise ValueError(f"line {k}: expected 4 tab-separated "
                                     f"fields, got {line!r}")
                prompt_text, prompt_audio, text, audio_path = fields
                logging.info(f"synthesize text: {text}")
                text_ids, text_lens = text_collater([tokenize_text(
                    text_tokenizer, f"{prompt_text} {text}".strip())])
                prompt_codes = tokenize_audio(audio_tokenizer, prompt_audio)
                codes = _synthesize(
                    model, args, text_ids, text_lens, prompt_codes,
                    np.array([prompt_codes.shape[1]], np.int32),
                    _enroll_lens(text_tokenizer, prompt_text), generator,
                    device)
                if codes.shape[0] == 0:
                    logging.warning(f"line {k}: empty generation; skipped")
                    continue
                save(Path(audio_path), codes)
        return

    text_prompts = " ".join(args.text_prompts.split("|"))
    if args.audio_prompts:
        audio_prompts = np.concatenate(
            [tokenize_audio(audio_tokenizer, f)
             for f in args.audio_prompts.split("|")], axis=1)
    else:
        audio_prompts = np.zeros((1, 0, Q), np.int32)
    P = audio_prompts.shape[1]
    prompt_codes = (audio_prompts if P > 0
                    else np.zeros((1, 1, Q), np.int32))
    for n, text in enumerate(args.text.split("|")):
        logging.info(f"synthesize text: {text}")
        # prompt text and target text are phonemized together
        text_ids, text_lens = text_collater([tokenize_text(
            text_tokenizer, f"{text_prompts} {text}".strip())])
        codes = _synthesize(model, args, text_ids, text_lens, prompt_codes,
                            np.array([P], np.int32),
                            _enroll_lens(text_tokenizer, text_prompts),
                            generator, device, continual=args.continual)
        if codes.shape[0] == 0:
            logging.warning(f"utterance {n}: empty generation")
            continue
        save(out_dir / f"{n}.wav", codes)


if __name__ == "__main__":
    main()
