"""Data: host image layer, augmentation, datasets and loaders, dataset YAML, synthetic data (yolov3_tpu/data/)."""
