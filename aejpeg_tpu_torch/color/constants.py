"""Color-space constants (matrices, normalization midpoints/scales).

These numeric constants are the public data of the color spaces implemented by
the reference (sYCC / YCoCg / YCoCg-R / XYZ / OKLAB / ICtCp / ICaCb / JzAzBz):
 - YCbCr matrices: reference src/color/ycbcr.py:25-42
 - YCoCg / YCoCg-R: src/color/ycocg.py:25-63
 - XYZ (sRGB D65): src/color/xyz.py:27-44
 - OKLAB: src/color/oklab.py:27-52
 - ICtCp (BT.2100): src/color/ictcp.py:142-163
 - ICaCb: src/color/icacb.py:142-163
 - JzAzBz: src/color/jzazbz.py:177-210
Midpoint/scale pairs were derived in the reference by sweeping the full 256^3
sRGB lattice (test/analysis/color_normalization.py) so each channel maps into
~[-127, 127].
"""

import numpy as np

F32 = np.float32

# ---------------------------------------------------------------- YCbCr (sYCC)
M_SRGB_TO_YCBCR = np.array([
    [0.299000, 0.587000, 0.114000],
    [-0.168736, -0.331264, 0.500000],
    [0.500000, -0.418688, -0.081312],
], dtype=F32)
M_YCBCR_TO_SRGB = np.array([
    [1.000000, 0.000037, 1.401988],
    [1.000000, -0.344113, -0.714104],
    [1.000000, 1.771978, 0.000135],
], dtype=F32)
YCBCR_MIDPOINTS = np.array(
    [0.5000000037252903, 7.450580596923828e-09, 0.0], dtype=F32)
YCBCR_SCALES = np.array(
    [253.99999810755253, 254.000003784895, 254.0], dtype=F32)

# ---------------------------------------------------------------------- YCoCg
M_SRGB_TO_YCOCG = np.array([
    [0.25, 0.50, 0.25],
    [0.50, 0.00, -0.50],
    [-0.25, 0.50, -0.25],
], dtype=F32)
M_YCOCG_TO_SRGB = np.array([
    [1.0, 1.0, -1.0],
    [1.0, 0.0, 1.0],
    [1.0, -1.0, -1.0],
], dtype=F32)
YCOCG_MIDPOINTS = np.array([0.5, 0.0, 0.0], dtype=F32)
YCOCG_SCALES = np.array([254.0, 254.0, 254.0], dtype=F32)

M_SRGB_TO_YCOCG_R = np.array([
    [0.25, 0.50, 0.25],
    [1.00, 0.00, -1.00],
    [-0.50, 1.00, -0.50],
], dtype=F32)
M_YCOCG_R_TO_SRGB = np.array([
    [1.00, 0.50, -0.50],
    [1.00, 0.00, 0.50],
    [1.00, -0.50, -0.50],
], dtype=F32)
YCOCG_R_MIDPOINTS = np.array([0.5, 0.0, 0.0], dtype=F32)
YCOCG_R_SCALES = np.array([254.0, 127.0, 127.0], dtype=F32)

# ------------------------------------------------------------------ XYZ (D65)
M_LINEAR_RGB_TO_XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], dtype=F32)
M_XYZ_TO_LINEAR_RGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=F32)
XYZ_MIDPOINTS = np.array([0.47523502, 0.50000006, 0.544415], dtype=F32)
XYZ_SCALES = np.array([267.2362, 253.99997, 233.27792], dtype=F32)

# --------------------------------------------------------------------- OKLAB
OKLAB_M_XYZ_TO_LMS = np.array([
    [0.8189330101, 0.3618667424, -0.1288597137],
    [0.0329845436, 0.9293118715, 0.0361456387],
    [0.0482003018, 0.2643662691, 0.6338517070],
], dtype=F32)
OKLAB_M_LMS_TO_XYZ = np.linalg.inv(OKLAB_M_XYZ_TO_LMS)
OKLAB_M_LMSP_TO_LAB = np.array([
    [0.2104542553, 0.7936177850, -0.0040720468],
    [1.9779984951, -2.4285922050, 0.4505937099],
    [0.0259040371, 0.7827717662, -0.8086757660],
], dtype=F32)
OKLAB_M_LAB_TO_LMSP = np.linalg.inv(OKLAB_M_LMSP_TO_LAB)
OKLAB_MIDPOINTS = np.array([0.4999999, 0.021152213, -0.056563325], dtype=F32)
OKLAB_SCALES = np.array([254.00005, 497.9055, 497.94604], dtype=F32)

# --------------------------------------------------------------------- ICtCp
ICTCP_M_XYZ_TO_LMS = np.array([
    [0.3592, 0.6976, -0.0358],
    [-0.1922, 1.1004, 0.0755],
    [0.0070, 0.0749, 0.8434],
], dtype=F32)
ICTCP_M_LMS_TO_XYZ = np.linalg.inv(ICTCP_M_XYZ_TO_LMS)
ICTCP_M_LMSP_TO_ICTCP = np.array([
    [0.5000, 0.5000, 0.0000],
    [1.6137, -3.3234, 1.7097],
    [4.3781, -4.2455, -0.1325],
], dtype=F32)
ICTCP_M_ICTCP_TO_LMSP = np.linalg.inv(ICTCP_M_LMSP_TO_ICTCP)
ICTCP_MIDPOINTS = np.array(
    [0.07497266, -0.0008235276, 0.023989676], dtype=F32)
ICTCP_SCALES = np.array([1693.9674, 1133.9044, 1694.004], dtype=F32)

# --------------------------------------------------------------------- ICaCb
ICACB_M_XYZ_TO_RGBBAR = np.array([
    [0.37613, 0.70431, -0.05675],
    [-0.21649, 1.14744, 0.05356],
    [0.02567, 0.16713, 0.74235],
], dtype=F32)
ICACB_M_RGBBAR_TO_XYZ = np.linalg.inv(ICACB_M_XYZ_TO_RGBBAR)
ICACB_M_RGBP_TO_ICACB = np.array([
    [0.4949, 0.5037, 0.0015],
    [4.2854, -4.5462, 0.2609],
    [0.3605, 1.1499, -1.5105],
], dtype=F32)
ICACB_M_ICACB_TO_RGBP = np.linalg.inv(ICACB_M_RGBP_TO_ICACB)
ICACB_MIDPOINTS = np.array([0.07498085, 0.02180194, -0.018250957], dtype=F32)
ICACB_SCALES = np.array([1693.7823, 1838.5665, 1330.3855], dtype=F32)

# -------------------------------------------------------------------- JzAzBz
JZAZBZ_B = 1.15
JZAZBZ_G = 0.66
JZAZBZ_D = -0.56
JZAZBZ_D0 = 1.6295499532821566e-11
JZAZBZ_P = 1.7 * 2523 / (2 ** 5)  # custom PQ m2 exponent
JZAZBZ_M_XYZ_TO_LMS = np.array([
    [0.41478972, 0.579999, 0.0146480],
    [-0.2015100, 1.120649, 0.0531008],
    [-0.0166008, 0.264800, 0.6684799],
], dtype=F32)
JZAZBZ_M_LMS_TO_XYZ = np.linalg.inv(JZAZBZ_M_XYZ_TO_LMS)
JZAZBZ_M_LMSP_TO_IZAZBZ = np.array([
    [0.500000, 0.500000, 0.000000],
    [3.524000, -4.066708, 0.542708],
    [0.199076, 1.096799, -1.295875],
], dtype=F32)
JZAZBZ_M_IZAZBZ_TO_LMSP = np.linalg.inv(JZAZBZ_M_LMSP_TO_IZAZBZ)
JZAZBZ_MIDPOINTS = np.array(
    [0.0087900255, 0.00048353244, -0.0020741792], dtype=F32)
JZAZBZ_SCALES = np.array([14448.194, 7590.505, 5552.201], dtype=F32)

# ------------------------------------------------------------- PQ (SMPTE 2084)
PQ_C1 = 3424 / (2 ** 12)
PQ_C2 = 2413 / (2 ** 7)
PQ_C3 = 2392 / (2 ** 7)
PQ_M1 = 2610 / (2 ** 14)
PQ_M2 = 2523 / (2 ** 5)
PQ_LP = 10000.0
