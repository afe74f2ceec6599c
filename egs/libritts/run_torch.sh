#!/usr/bin/env bash
# LibriTTS end-to-end drill in the PyTorch port: download -> prepare -> AR
# stage -> NAR stage -> demo synthesis, through valle_tpu_torch.bin.* on
# ``device`` (default cuda). The port's twin of run.sh (reference
# README.md:84-129); the recipe's settings are run.sh's.
#
#   bash run_torch.sh
#
# Stages: 0 download | 1 manifests | 2 tokenize | 3 stats |
#         4 AR train | 5 NAR train | 6 demo inference
#
# Overridable (env): everything prepare_torch.sh takes (device included:
# the tokenizer, both trainer stages and the demo run there), plus
#   exp_dir, num_epochs_ar, num_epochs_nar, max_duration_ar,
#   max_duration_nar, model_args (dims; shrink for smoke tests),
#   train_extra (appended to both trainer calls), infer_extra,
#   demo_text, dtype_ar, dtype_nar.
# Checkpoints are .pt files: exp_dir/{epoch-N,best-valid-loss,
# best-train-loss}.pt.
set -eou pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-6}
data_dir=${data_dir:-data}
exp_dir=${exp_dir:-exp/valle}
device=${device:-cuda}
text_extractor=${text_extractor:-espeak}
num_epochs_ar=${num_epochs_ar:-20}
num_epochs_nar=${num_epochs_nar:-40}
max_duration_ar=${max_duration_ar:-80}
max_duration_nar=${max_duration_nar:-40}
dtype_ar=${dtype_ar:-bfloat16}
# float32 mirrors the reference NAR recipe
dtype_nar=${dtype_nar:-float32}
model_args=${model_args:---model-name valle --share-embedding true \
  --norm-first true --add-prenet false --decoder-dim 1024 --nhead 16 \
  --num-decoder-layers 12 --prefix-mode 1}
train_extra=${train_extra:-}
infer_extra=${infer_extra:-}
demo_text=${demo_text:-To get up and running quickly just follow the steps below.}

cd "$(dirname "$0")"
export PYTHONPATH="$(pwd)/../..:${PYTHONPATH:-}"
tokenized=$data_dir/tokenized
text_tokens=$tokenized/unique_text_tokens.k2symbols

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 0 ]; then
  stage=$stage stop_stage=$((stop_stage < 3 ? stop_stage : 3)) \
    data_dir=$data_dir text_extractor=$text_extractor device=$device \
    bash prepare_torch.sh
fi

common_train_args="--manifest-dir $tokenized --text-tokens $text_tokens \
  --filter-min-duration 0.5 --filter-max-duration 14 --num-buckets 6 \
  --save-every-n 10000 --valid-interval 20000 \
  --base-lr 0.05 --warmup-steps 200 --average-period 0 \
  --accumulate-grad-steps 4 --exp-dir $exp_dir --device $device \
  $model_args $train_extra"

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "Stage 4: AR training ($num_epochs_ar epochs, $dtype_ar, $device;"
  echo "         reference README.md:96-102)"
  # shellcheck disable=SC2086
  python3 -m valle_tpu_torch.bin.trainer $common_train_args \
    --max-duration "$max_duration_ar" --dtype "$dtype_ar" \
    --num-epochs "$num_epochs_ar" --start-epoch 1 --start-batch 0 \
    --train-stage 1
fi

# best checkpoint on disk: best-valid-loss.pt (written on validation) or,
# on runs too short to validate, best-train-loss.pt
best_ckpt() {
  if [ -f "$exp_dir/best-valid-loss.pt" ]; then
    echo "$exp_dir/best-valid-loss.pt"
  else
    echo "$exp_dir/best-train-loss.pt"
  fi
}

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "Stage 5: NAR training ($num_epochs_nar epochs, $dtype_nar, $device;"
  echo "         stage-switch seed from the AR best, reference :106-112)"
  if [ ! -f "$exp_dir/epoch-2.pt" ]; then
    cp "$(best_ckpt)" "$exp_dir/epoch-2.pt"
  fi
  # shellcheck disable=SC2086
  python3 -m valle_tpu_torch.bin.trainer $common_train_args \
    --max-duration "$max_duration_nar" --dtype "$dtype_nar" \
    --num-epochs "$num_epochs_nar" --start-epoch 3 --start-batch 0 \
    --train-stage 2
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "Stage 6: demo synthesis -> $exp_dir/demos ($device)"
  # shellcheck disable=SC2086
  python3 -m valle_tpu_torch.bin.infer --output-dir "$exp_dir/demos" \
    --checkpoint "$(best_ckpt)" \
    --text-tokens "$text_tokens" \
    --text "$demo_text" \
    --top-k -100 --temperature 1.0 --device "$device" $infer_extra
fi
