#!/usr/bin/env bash
# LibriTTS recipe (parity with reference egs/libritts/prepare.sh: 7 parts,
# 555 h).
#
# The PyTorch port's copy: it calls valle_tpu_torch.bin.*, and stage 2
# encodes the audio on ``device`` (default cuda; the tokenizer's
# --device).
set -eou pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-3}
dl_dir=${dl_dir:-download}
corpus_dir=${corpus_dir:-$dl_dir/LibriTTS}
train_parts=${train_parts:-train-clean-100,train-clean-360,train-other-500}
dl_parts=${dl_parts:-dev-clean,test-clean,$train_parts}
text_extractor=${text_extractor:-espeak}
data_dir=${data_dir:-data}
device=${device:-cuda}
manifests=$data_dir/manifests
tokenized=$data_dir/tokenized

cd "$(dirname "$0")"
export PYTHONPATH="$(pwd)/../..:${PYTHONPATH:-}"

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  echo "Stage 0: download LibriTTS parts (reference prepare.sh stage 0;"
  echo "         openslr resource 60)"
  mkdir -p "$dl_dir"
  for part in $(echo "$dl_parts" | tr ',' ' '); do
    if [ ! -d "$corpus_dir/$part" ]; then
      url="https://www.openslr.org/resources/60/${part}.tar.gz"
      if command -v wget >/dev/null; then
        wget -c -O "$dl_dir/${part}.tar.gz" "$url"
      else
        curl -L -C - -o "$dl_dir/${part}.tar.gz" "$url"
      fi
      tar -xzf "$dl_dir/${part}.tar.gz" -C "$dl_dir"
    fi
  done
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "Stage 1: prepare manifests"
  python3 -m valle_tpu_torch.bin.prepare_manifests \
    --dataset libritts --corpus-dir "$corpus_dir" \
    --libritts-train-parts "$train_parts" --output-dir $manifests
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "Stage 2: tokenize (EnCodec on $device + $text_extractor)"
  python3 -m valle_tpu_torch.bin.tokenizer \
    --src-dir $manifests --output-dir $tokenized \
    --audio-extractor Encodec --text-extractor $text_extractor \
    --batch-duration 400 --device "$device"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  python3 -m valle_tpu_torch.bin.display_manifest_statistics \
    --manifest-dir $tokenized
fi
