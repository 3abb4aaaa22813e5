from gtsfm_tpu_torch.geometry.se3 import SE3
from gtsfm_tpu_torch.geometry.sim3 import Sim3
from gtsfm_tpu_torch.geometry.calibration import CALIBRATION_TYPES, Cal3Bundler, Cal3DS2, Cal3Fisheye, Cal3_S2
from gtsfm_tpu_torch.geometry.cameras import PinholeCamera

__all__ = ["SE3", "Sim3", "Cal3Bundler", "Cal3_S2", "Cal3DS2", "Cal3Fisheye", "CALIBRATION_TYPES", "PinholeCamera"]
