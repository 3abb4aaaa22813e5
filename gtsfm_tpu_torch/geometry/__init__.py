from gtsfm_tpu_torch.geometry.se3 import SE3
from gtsfm_tpu_torch.geometry.sim3 import Sim3
from gtsfm_tpu_torch.geometry.calibration import Cal3Bundler
from gtsfm_tpu_torch.geometry.cameras import PinholeCamera

__all__ = ["SE3", "Sim3", "Cal3Bundler", "PinholeCamera"]
