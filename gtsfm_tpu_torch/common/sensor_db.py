"""Camera model -> sensor width (mm) lookup for EXIF focal estimation.

The port's copy of gtsfm_tpu/common/sensor_db.py, unchanged: a compact
subset of widely seen camera models; unknown models fall back to the
default focal-ratio prior in common/image.py.
"""

SENSOR_WIDTHS_MM = {
    # key: lowercase "make model" or just "model"
    "nikon d3100": 23.1,
    "nikon d90": 23.6,
    "nikon d80": 23.6,
    "nikon d70": 23.7,
    "nikon d200": 23.6,
    "nikon d300": 23.6,
    "nikon d700": 36.0,
    "nikon d750": 35.9,
    "canon eos 5d": 35.8,
    "canon eos 5d mark ii": 36.0,
    "canon eos 5d mark iii": 36.0,
    "canon eos 6d": 35.8,
    "canon eos 7d": 22.3,
    "canon eos 40d": 22.2,
    "canon eos 60d": 22.3,
    "canon eos 400d digital": 22.2,
    "canon eos 550d": 22.3,
    "canon eos rebel t2i": 22.3,
    "canon powershot s95": 7.6,
    "canon powershot g9": 7.6,
    "sony ilce-7m3": 35.8,
    "sony ilce-7rm3": 35.9,
    "sony dsc-rx100": 13.2,
    "iphone 11": 5.76,
    "iphone 12": 5.76,
    "iphone 13": 7.01,
    "iphone 14": 7.01,
    "iphone 8": 4.8,
    "iphone x": 5.76,
    "pixel 6": 6.4,
    "pixel 7": 6.4,
    "dji fc330": 6.25,
    "dji fc6310": 13.2,
    "skydio r1": 5.09,
    "skydio 2": 6.4,
}
