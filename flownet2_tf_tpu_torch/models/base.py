"""Model-zoo shared constants (port of ``flownet2_tf_tpu/models/base.py``).

The multi-scale loss and its weights come with training.
"""

FLOW_SCALE = 0.05  # = 1/20: network-internal flow units
