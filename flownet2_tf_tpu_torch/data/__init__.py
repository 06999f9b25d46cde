"""Data pipeline of the torch port: synthetic data, the dataset readers,
TFRecords, batching and augmentation (``flownet2_tf_tpu/data``
counterparts)."""
