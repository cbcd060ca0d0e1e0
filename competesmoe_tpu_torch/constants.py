"""Constants of the serving slice (a copy of the ones it uses from
competesmoe_tpu/constants.py)."""

WORKER_HEART_BEAT_INTERVAL = 15

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
