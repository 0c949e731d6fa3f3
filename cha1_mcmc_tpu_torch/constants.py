"""Physical constants.

Values deliberately use the reference's *truncated* CODATA values
(reference spectral_simulator/constants.py:1-7) rather than full-precision
ones: posterior parity with the reference requires adopting its constants
(the vendored tool carries more digits, but the live pipeline does not).
"""

KCM = 0.69503476      # Boltzmann's constant in cm^-1/K
CKM = 2.998e5         # Speed of light in km/s
CCM = 2.998e10        # Speed of light in cm/s
CM = 2.998e8          # Speed of light in m/s
H = 6.626e-34         # Planck's constant in J*s
K = 1.381e-23         # Boltzmann's constant in J/K

# MHz -> eupper conversion divisor used by the reference catalog parser
# (reference spectral_simulator/classes.py:90). Note this is the *precise*
# speed of light in thousands of km/s, unlike CKM above.
EUPPER_CONV = 29979.2458

# Constant appearing in the sijmu derivation (reference classes.py:95).
SIJMU_CONST = 4.16231e-5

# Constant in the CDMS Einstein-A formula (reference classes.py:98).
AIJ_CONST = 1.16395e-20

# Radians -> arcseconds (reference inference.py:38).
RAD_TO_ARCSEC = 206265.0

# Diffraction-limited beam factor (reference inference.py:38).
BEAM_FACTOR = 1.22

# Cosmic microwave background temperature in K (reference inference.py:57,
# spectral_simulator/classes.py:492 default Tbg).
T_CMB = 2.7

# FWHM -> sigma conversion. The hot-loop model kernel uses the truncated
# 2.355 (reference inference.py:53), while the offline Gaussian renderer
# uses 2.35482 (reference spectral_simulator/functions.py:607).
FWHM_TO_SIGMA_MODEL = 2.355
FWHM_TO_SIGMA_PLOT = 2.35482

# Velocity window half-width for line accumulation, in units of dV
# (reference inference.py:52).
VELOCITY_WINDOW_DV = 10.0

# ANSI color codes for console logging (reference constants.py:10-14).
CYAN = "\033[36m"
GRAY = "\033[90m"
RED = "\033[31m"
GREEN = "\033[92m"
RESET = "\033[0m"
