#!/usr/bin/env bash
# Training launcher of the PyTorch/CUDA port with the JAX launcher's
# per-model presets (scripts/run_train.sh, parity with the reference
# run_train.sh:9-41).  Runs on the GPU; pass --device cpu to train on the
# CPU.
set -euo pipefail

MODEL=${MODEL:-ResNet20qat}          # ResNet20qat | ResNet18qat | ResNet20 | ResNet18
DATASET=${DATASET:-cifar10}          # cifar10 | ImageNet | Imagenette | miniImagenet | synthetic
DATASET_PATH=${DATASET_PATH:-./cifardataset}
SAVE_PATH=${SAVE_PATH:-./runs}
NUM_CLASSES=${NUM_CLASSES:-10}
STOP_EPOCH=${STOP_EPOCH:-400}
BATCH_SIZE=${BATCH_SIZE:-128}
LR=${LR:-0.001}
OPTIMIZER=${OPTIMIZER:-adam}

# Per-model DCT presets (reference run_train.sh: filter_size 4 for
# ResNet20, 8 for ResNet18; bit_width 4 for CIFAR, 5 for ImageNet)
case "$MODEL" in
  ResNet20*)
    FILTER_SIZE=${FILTER_SIZE:-4}
    CHANNELS=${CHANNELS:-24}
    IMAGE_SIZE_DCT=${IMAGE_SIZE_DCT:-16}
    BIT_WIDTH=${BIT_WIDTH:-4}
    ;;
  ResNet18*)
    FILTER_SIZE=${FILTER_SIZE:-8}
    CHANNELS=${CHANNELS:-64}
    IMAGE_SIZE_DCT=${IMAGE_SIZE_DCT:-56}
    if [ "$DATASET" = "ImageNet" ]; then
      BIT_WIDTH=${BIT_WIDTH:-5}
    else
      BIT_WIDTH=${BIT_WIDTH:-4}
    fi
    ;;
esac

exec python -m dct_cryptonets_tpu_torch.train \
  --dataset "$DATASET" \
  --dataset_path "$DATASET_PATH" \
  --save_path "$SAVE_PATH" \
  --model "$MODEL" \
  --num_classes "$NUM_CLASSES" \
  --dct_status \
  --train_aug \
  --channels "$CHANNELS" \
  --filter_size "$FILTER_SIZE" \
  --image_size_dct "$IMAGE_SIZE_DCT" \
  --bit_width "$BIT_WIDTH" \
  --stop_epoch "$STOP_EPOCH" \
  --batch_size "$BATCH_SIZE" \
  --test_batch_size 256 \
  --optimizer "$OPTIMIZER" \
  --lr "$LR" \
  "$@"
