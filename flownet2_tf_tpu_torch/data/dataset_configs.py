"""Dataset configuration dicts: a copy of
``flownet2_tf_tpu/data/dataset_configs.py`` (pure dicts, copied so that the
port imports no JAX; keep the two equal).

Schema parity: reference ``src/dataset_configs.py`` — per-dataset dicts
with TFRecord ``PATHS`` {train, validate}, example counts ``SIZES``,
``BATCH_SIZE``, ``IMAGE_HEIGHT/WIDTH`` and a ``PREPROCESS`` sub-dict with
the crop size and the Caffe-style per-transform augmentation parameter
spec. Each transform entry is
``{'rand_type': 'uniform_bernoulli' | 'gaussian_bernoulli',
   'exp': bool, 'mean': mu, 'spread': sigma, 'prob': p}``
and is consumed verbatim by the device-side augmentation module
(data/augmentation.py).

The ``image_a`` spec drives the base transform; the ``image_b`` spec
drives the *incremental* A->B jitter (the reference's correlated-but-
jittered pair transforms).

Values follow the FlowNet training recipe (translate +-0.4 of size,
rotation +-0.4 rad, zoom exp[0.2 +- 0.4], squeeze exp[+-0.3], photometric
gaussian jitters ~0.02, additive gaussian noise U[0, 0.04]).
"""

from __future__ import annotations

import copy

_CHAIRS_AUG_A = {
    "translate": {
        "rand_type": "uniform_bernoulli", "exp": False,
        "mean": 0.0, "spread": 0.4, "prob": 1.0,
    },
    "rotate": {
        "rand_type": "uniform_bernoulli", "exp": False,
        "mean": 0.0, "spread": 0.4, "prob": 1.0,
    },
    "zoom": {
        "rand_type": "uniform_bernoulli", "exp": True,
        "mean": 0.2, "spread": 0.4, "prob": 1.0,
    },
    "squeeze": {
        "rand_type": "uniform_bernoulli", "exp": True,
        "mean": 0.0, "spread": 0.3, "prob": 1.0,
    },
    "noise": {
        "rand_type": "uniform_bernoulli", "exp": False,
        "mean": 0.03, "spread": 0.03, "prob": 1.0,
    },
}

_CHAIRS_AUG_B = {
    # incremental spatial jitter of image B relative to image A
    "translate": {
        "rand_type": "gaussian_bernoulli", "exp": False,
        "mean": 0.0, "spread": 0.03, "prob": 1.0,
    },
    "rotate": {
        "rand_type": "gaussian_bernoulli", "exp": False,
        "mean": 0.0, "spread": 0.03, "prob": 1.0,
    },
    "zoom": {
        "rand_type": "gaussian_bernoulli", "exp": True,
        "mean": 0.0, "spread": 0.03, "prob": 1.0,
    },
    # photometric (applied per-image, B relative to A)
    "brightness": {
        "rand_type": "gaussian_bernoulli", "exp": False,
        "mean": 0.0, "spread": 0.02, "prob": 1.0,
    },
    "gamma": {
        "rand_type": "gaussian_bernoulli", "exp": True,
        "mean": 0.0, "spread": 0.02, "prob": 1.0,
    },
    "contrast": {
        "rand_type": "gaussian_bernoulli", "exp": True,
        "mean": 0.0, "spread": 0.02, "prob": 1.0,
    },
    "color": {
        "rand_type": "gaussian_bernoulli", "exp": True,
        "mean": 0.0, "spread": 0.02, "prob": 1.0,
    },
}

FLYING_CHAIRS_DATASET_CONFIG = {
    "NAME": "flying_chairs",
    # TFRecords written with features image_a/image_b/flow (raw bytes),
    # matching the reference's record layout; RAW_ROOT alternatively
    # points at the original .ppm/.flo release.
    "PATHS": {
        "train": "./data/tfrecords/fc_train.tfrecords",
        "validate": "./data/tfrecords/fc_val.tfrecords",
    },
    "RAW_ROOT": "./data/FlyingChairs_release/data",
    "SIZES": {"train": 22232, "validate": 640},
    "BATCH_SIZE": 8,
    "IMAGE_HEIGHT": 384,
    "IMAGE_WIDTH": 512,
    "PREPROCESS": {
        "scale": False,
        "crop_height": 320,
        "crop_width": 448,
        "image_a": copy.deepcopy(_CHAIRS_AUG_A),
        "image_b": copy.deepcopy(_CHAIRS_AUG_B),
    },
}

# Chromatic-eigen parameter spec (FlowNet2 fine-tuning recipe): pow /
# mult / add chains for luminance, saturation and per-eigen-channel
# color, consumed by data/augmentation.py::apply_chromatic_eigen.
_CHROMATIC_EIGEN = {
    "lmult_pow": {"rand_type": "gaussian_bernoulli", "exp": True,
                  "mean": -0.2, "spread": 0.4, "prob": 1.0},
    "lmult_mult": {"rand_type": "gaussian_bernoulli", "exp": True,
                   "mean": 0.0, "spread": 0.4, "prob": 1.0},
    "lmult_add": {"rand_type": "gaussian_bernoulli", "exp": False,
                  "mean": 0.0, "spread": 0.03, "prob": 1.0},
    "sat_pow": {"rand_type": "gaussian_bernoulli", "exp": True,
                "mean": 0.0, "spread": 0.4, "prob": 1.0},
    "sat_mult": {"rand_type": "gaussian_bernoulli", "exp": True,
                 "mean": -0.3, "spread": 0.5, "prob": 1.0},
    "sat_add": {"rand_type": "gaussian_bernoulli", "exp": False,
                "mean": 0.0, "spread": 0.03, "prob": 1.0},
    "col_pow": {"rand_type": "gaussian_bernoulli", "exp": True,
                "mean": 0.0, "spread": 0.4, "prob": 1.0},
    "col_mult": {"rand_type": "gaussian_bernoulli", "exp": True,
                 "mean": 0.0, "spread": 0.2, "prob": 1.0},
    "col_add": {"rand_type": "gaussian_bernoulli", "exp": False,
                "mean": 0.0, "spread": 0.02, "prob": 1.0},
    "ladd_pow": {"rand_type": "gaussian_bernoulli", "exp": True,
                 "mean": 0.0, "spread": 0.4, "prob": 1.0},
    "ladd_mult": {"rand_type": "gaussian_bernoulli", "exp": True,
                  "mean": 0.0, "spread": 0.4, "prob": 1.0},
    "ladd_add": {"rand_type": "gaussian_bernoulli", "exp": False,
                 "mean": 0.0, "spread": 0.04, "prob": 1.0},
}

FLYING_THINGS_3D_DATASET_CONFIG = {
    "NAME": "flying_things_3d",
    "PATHS": {
        "train": "./data/tfrecords/ft3d_train.tfrecords",
        "validate": "./data/tfrecords/ft3d_val.tfrecords",
    },
    "RAW_ROOT": "./data/FlyingThings3D",
    "SIZES": {"train": 21818, "validate": 4248},
    "BATCH_SIZE": 8,
    "IMAGE_HEIGHT": 540,
    "IMAGE_WIDTH": 960,
    "PREPROCESS": {
        "scale": False,
        "crop_height": 384,
        "crop_width": 768,
        "image_a": {**copy.deepcopy(_CHAIRS_AUG_A),
                    **copy.deepcopy(_CHROMATIC_EIGEN)},
        "image_b": copy.deepcopy(_CHAIRS_AUG_B),
    },
}

# ChairsSDHom — the small-displacement set used to train FlowNetSD
# (FlowNet2 paper §4). Spatial augmentation is kept gentle (small
# displacements must survive augmentation).
CHAIRS_SDHOM_DATASET_CONFIG = {
    "NAME": "chairs_sdhom",
    "PATHS": {
        "train": "./data/tfrecords/sdhom_train.tfrecords",
        "validate": "./data/tfrecords/sdhom_val.tfrecords",
    },
    "RAW_ROOT": "./data/ChairsSDHom",
    "SIZES": {"train": 20965, "validate": 2000},
    "BATCH_SIZE": 8,
    "IMAGE_HEIGHT": 384,
    "IMAGE_WIDTH": 512,
    "PREPROCESS": {
        "scale": False,
        "crop_height": 320,
        "crop_width": 448,
        "image_a": {
            "translate": {
                "rand_type": "uniform_bernoulli", "exp": False,
                "mean": 0.0, "spread": 0.2, "prob": 1.0,
            },
            "rotate": {
                "rand_type": "uniform_bernoulli", "exp": False,
                "mean": 0.0, "spread": 0.2, "prob": 1.0,
            },
            "zoom": {
                "rand_type": "uniform_bernoulli", "exp": True,
                "mean": 0.1, "spread": 0.2, "prob": 1.0,
            },
            "noise": {
                "rand_type": "uniform_bernoulli", "exp": False,
                "mean": 0.03, "spread": 0.03, "prob": 1.0,
            },
        },
        "image_b": copy.deepcopy(_CHAIRS_AUG_B),
    },
}

# Evaluation-oriented configs (the reference fork reportedly added
# dataset-list evaluation; these cover the Sintel/KITTI eval surface).
SINTEL_DATASET_CONFIG = {
    "NAME": "sintel",
    "RAW_ROOT": "./data/MPI-Sintel-complete",
    "PASSES": ("clean", "final"),
    "SIZES": {"train": 1041},
    "BATCH_SIZE": 4,
    "IMAGE_HEIGHT": 436,
    "IMAGE_WIDTH": 1024,
    # inference pads to the next multiple of 64 (448 x 1024)
    "PREPROCESS": {
        "scale": False,
        "crop_height": 384,
        "crop_width": 768,
        "image_a": copy.deepcopy(_CHAIRS_AUG_A),
        "image_b": copy.deepcopy(_CHAIRS_AUG_B),
    },
}

KITTI_DATASET_CONFIG = {
    "NAME": "kitti",
    "RAW_ROOT": "./data/kitti_flow_2012",
    "SIZES": {"train": 194},
    "BATCH_SIZE": 4,
    "IMAGE_HEIGHT": 375,
    "IMAGE_WIDTH": 1242,
    "PREPROCESS": {
        "scale": False,
        "crop_height": 320,
        "crop_width": 896,
        "image_a": copy.deepcopy(_CHAIRS_AUG_A),
        "image_b": copy.deepcopy(_CHAIRS_AUG_B),
    },
}

DATASETS = {
    "chairs": FLYING_CHAIRS_DATASET_CONFIG,
    "flying_chairs": FLYING_CHAIRS_DATASET_CONFIG,
    "things": FLYING_THINGS_3D_DATASET_CONFIG,
    "flying_things_3d": FLYING_THINGS_3D_DATASET_CONFIG,
    "sdhom": CHAIRS_SDHOM_DATASET_CONFIG,
    "chairs_sdhom": CHAIRS_SDHOM_DATASET_CONFIG,
    "sintel": SINTEL_DATASET_CONFIG,
    "kitti": KITTI_DATASET_CONFIG,
}


def get_dataset_config(name: str):
    try:
        return DATASETS[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; available: {sorted(set(DATASETS))}"
        ) from None
