"""Validation: mAP of a DetectionModel (validator), its metrics and the COCO bbox evaluator."""
