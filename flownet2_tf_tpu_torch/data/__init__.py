"""Data pipeline of the torch port: synthetic data, batching and
augmentation (``flownet2_tf_tpu/data`` counterparts)."""
