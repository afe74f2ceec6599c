#!/usr/bin/env bash
# LJSpeech recipe (debug-scale; parity with reference egs/ljspeech/prepare.sh).
#
# The PyTorch port's copy: it calls valle_tpu_torch.bin.*, and stage 2
# encodes the audio on ``device`` (default cuda; the tokenizer's
# --device).
set -eou pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-3}
dl_dir=${dl_dir:-download}
corpus_dir=${corpus_dir:-$dl_dir/LJSpeech-1.1}
text_extractor=${text_extractor:-espeak}
data_dir=${data_dir:-data}
device=${device:-cuda}
manifests=$data_dir/manifests
tokenized=$data_dir/tokenized

cd "$(dirname "$0")"
export PYTHONPATH="$(pwd)/../..:${PYTHONPATH:-}"

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  echo "Stage 0: download LJSpeech (reference prepare.sh stage 0)"
  # pre-downloaded? symlink it:  ln -sfv /path/to/LJSpeech-1.1 $dl_dir/
  if [ ! -d "$corpus_dir" ]; then
    mkdir -p "$dl_dir"
    url=https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2
    if command -v wget >/dev/null; then
      wget -c -O "$dl_dir/LJSpeech-1.1.tar.bz2" "$url"
    else
      curl -L -C - -o "$dl_dir/LJSpeech-1.1.tar.bz2" "$url"
    fi
    tar -xjf "$dl_dir/LJSpeech-1.1.tar.bz2" -C "$dl_dir"
  fi
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "Stage 1: prepare manifests (12500/200/400 split)"
  python3 -m valle_tpu_torch.bin.prepare_manifests \
    --dataset ljspeech --corpus-dir "$corpus_dir" --output-dir $manifests
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "Stage 2: tokenize (EnCodec codes on $device + $text_extractor)"
  python3 -m valle_tpu_torch.bin.tokenizer \
    --src-dir $manifests --output-dir $tokenized \
    --audio-extractor Encodec --text-extractor $text_extractor \
    --batch-duration 400 --device "$device"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "Stage 3: manifest statistics"
  python3 -m valle_tpu_torch.bin.display_manifest_statistics \
    --manifest-dir $tokenized
fi
