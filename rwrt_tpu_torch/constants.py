"""Physical and numerical constants (port of ``rwrt_tpu/constants.py``).

Plain Python floats, so they take the precision of the tensor they meet.
"""

import math

pi: float = 3.14159265358979323846264338327950288419716939937510
deg2rad: float = pi / 180.0
rad2deg: float = 180.0 / pi

#: Earth radius in meters.
rearth: float = 6.3712e6
#: Earth rotation rate in 1/s.
omega: float = 7.2921e-5

one: float = 1.0
zero: float = 0.0

hour: float = 3600.0
day: float = 24.0 * hour

#: Threshold for approximate float equality; a polynomial root is real when
#: |Im| < delt.
delt: float = 1.0e-8

#: Missing-value marker: dead rays are NaN lanes.
undef: float = math.nan

#: Polar cap guard: background sampling returns zeros where
#: |cos(lat)| <= this.
polar_cos_cap: float = 0.0175

#: Runaway meridional wavenumber cutoff: |m*R| >= 100 terminates a ray.
mwn_cap: float = 100.0
