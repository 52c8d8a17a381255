"""Evaluation nets (counterpart of waldo_tpu/eval/): the LPIPS distance, the
Frechet distances and their extractors (Inception for FID, I3D for FVD)."""
from .frechet import fid_videos, frechet_distance, frechet_distance_from_acts, fvd_proxy
from .i3d import I3D, I3DExtractor
from .inception import InceptionExtractor, InceptionV3Features
from .lpips import LPIPS, convert_lpips_state_dict
