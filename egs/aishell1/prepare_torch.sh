#!/usr/bin/env bash
# AIShell-1 recipe (Chinese; parity with reference egs/aishell1: pypinyin
# initials/finals text frontend).
#
# The PyTorch port's copy: it calls valle_tpu_torch.bin.*, and stage 2
# encodes the audio on ``device`` (default cuda; the tokenizer's
# --device).
set -eou pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-3}
dl_dir=${dl_dir:-download}
corpus_dir=${corpus_dir:-$dl_dir/aishell/data_aishell}
text_extractor=${text_extractor:-pypinyin_initials_finals}
data_dir=${data_dir:-data}
device=${device:-cuda}
manifests=$data_dir/manifests
tokenized=$data_dir/tokenized

cd "$(dirname "$0")"
export PYTHONPATH="$(pwd)/../..:${PYTHONPATH:-}"

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  echo "Stage 0: download AIShell-1 (openslr resource 33)"
  if [ ! -d "$corpus_dir" ]; then
    mkdir -p "$dl_dir/aishell"
    url=https://www.openslr.org/resources/33/data_aishell.tgz
    if command -v wget >/dev/null; then
      wget -c -O "$dl_dir/aishell/data_aishell.tgz" "$url"
    else
      curl -L -C - -o "$dl_dir/aishell/data_aishell.tgz" "$url"
    fi
    tar -xzf "$dl_dir/aishell/data_aishell.tgz" -C "$dl_dir/aishell"
    # per-utterance wavs ship as inner tarballs
    find "$corpus_dir/wav" -name "*.tar.gz" -execdir tar -xzf {} \; \
      -delete 2>/dev/null || true
  fi
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  python3 -m valle_tpu_torch.bin.prepare_manifests \
    --dataset aishell1 --corpus-dir "$corpus_dir" --output-dir $manifests
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  python3 -m valle_tpu_torch.bin.tokenizer \
    --src-dir $manifests --output-dir $tokenized \
    --audio-extractor Encodec \
    --text-extractor $text_extractor \
    --batch-duration 400 --device "$device"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  python3 -m valle_tpu_torch.bin.display_manifest_statistics \
    --manifest-dir $tokenized
fi
