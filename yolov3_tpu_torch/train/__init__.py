"""Training: loss, optimizer and schedules, EMA, the train step (yolov3_tpu/train/)."""
