"""Data parallelism of the port (yolov3_tpu/parallel): process groups for training, a
device mesh for serving and validation. See parallel/mesh.py."""
