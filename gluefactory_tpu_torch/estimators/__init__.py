"""Robust estimators of the port (counterpart of gluefactory_tpu/estimators)."""

from .base_estimator import BaseEstimator, load_estimator  # noqa: F401
from .ransac import RansacResult, ransac_homography, ransac_homography_core  # noqa: F401
