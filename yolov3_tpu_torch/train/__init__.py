"""Training: loss, optimizer and schedules, EMA, the train step, the trainer loop (yolov3_tpu/train/)."""
