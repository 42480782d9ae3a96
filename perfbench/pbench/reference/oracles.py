"""transformAssociateToMap (src/laserMapping.cpp:110-197,
src/transformMaintenance.cpp:60-145), a scalar transcription."""

from __future__ import annotations

import numpy as np


def plugin_imu_rotation_ref(bcx, bcy, bcz, blx, bly, blz, alx, aly, alz):
    """src/laserOdometry.cpp:196-254 (identical structure to
    transformAssociateToMap's rotation, src/laserMapping.cpp:126-182)."""
    sbcx, cbcx = np.sin(bcx), np.cos(bcx)
    sbcy, cbcy = np.sin(bcy), np.cos(bcy)
    sbcz, cbcz = np.sin(bcz), np.cos(bcz)
    sblx, cblx = np.sin(blx), np.cos(blx)
    sbly, cbly = np.sin(bly), np.cos(bly)
    sblz, cblz = np.sin(blz), np.cos(blz)
    salx, calx = np.sin(alx), np.cos(alx)
    saly, caly = np.sin(aly), np.cos(aly)
    salz, calz = np.sin(alz), np.cos(alz)

    srx = (
        -sbcx * (salx * sblx + calx * caly * cblx * cbly + calx * cblx * saly * sbly)
        - cbcx * cbcz * (
            calx * saly * (cbly * sblz - cblz * sblx * sbly)
            - calx * caly * (sbly * sblz + cbly * cblz * sblx)
            + cblx * cblz * salx
        )
        - cbcx * sbcz * (
            calx * caly * (cblz * sbly - cbly * sblx * sblz)
            - calx * saly * (cbly * cblz + sblx * sbly * sblz)
            + cblx * salx * sblz
        )
    )
    acx = -np.arcsin(srx)
    srycrx = (
        (cbcy * sbcz - cbcz * sbcx * sbcy) * (
            calx * saly * (cbly * sblz - cblz * sblx * sbly)
            - calx * caly * (sbly * sblz + cbly * cblz * sblx)
            + cblx * cblz * salx
        )
        - (cbcy * cbcz + sbcx * sbcy * sbcz) * (
            calx * caly * (cblz * sbly - cbly * sblx * sblz)
            - calx * saly * (cbly * cblz + sblx * sbly * sblz)
            + cblx * salx * sblz
        )
        + cbcx * sbcy * (salx * sblx + calx * caly * cblx * cbly + calx * cblx * saly * sbly)
    )
    crycrx = (
        (cbcz * sbcy - cbcy * sbcx * sbcz) * (
            calx * caly * (cblz * sbly - cbly * sblx * sblz)
            - calx * saly * (cbly * cblz + sblx * sbly * sblz)
            + cblx * salx * sblz
        )
        - (sbcy * sbcz + cbcy * cbcz * sbcx) * (
            calx * saly * (cbly * sblz - cblz * sblx * sbly)
            - calx * caly * (sbly * sblz + cbly * cblz * sblx)
            + cblx * cblz * salx
        )
        + cbcx * cbcy * (salx * sblx + calx * caly * cblx * cbly + calx * cblx * saly * sbly)
    )
    acy = np.arctan2(srycrx / np.cos(acx), crycrx / np.cos(acx))
    srzcrx = (
        sbcx * (
            cblx * cbly * (calz * saly - caly * salx * salz)
            - cblx * sbly * (caly * calz + salx * saly * salz)
            + calx * salz * sblx
        )
        - cbcx * cbcz * (
            (caly * calz + salx * saly * salz) * (cbly * sblz - cblz * sblx * sbly)
            + (calz * saly - caly * salx * salz) * (sbly * sblz + cbly * cblz * sblx)
            - calx * cblx * cblz * salz
        )
        + cbcx * sbcz * (
            (caly * calz + salx * saly * salz) * (cbly * cblz + sblx * sbly * sblz)
            + (calz * saly - caly * salx * salz) * (cblz * sbly - cbly * sblx * sblz)
            + calx * cblx * salz * sblz
        )
    )
    crzcrx = (
        sbcx * (
            cblx * sbly * (caly * salz - calz * salx * saly)
            - cblx * cbly * (saly * salz + caly * calz * salx)
            + calx * calz * sblx
        )
        + cbcx * cbcz * (
            (saly * salz + caly * calz * salx) * (sbly * sblz + cbly * cblz * sblx)
            + (caly * salz - calz * salx * saly) * (cbly * sblz - cblz * sblx * sbly)
            + calx * calz * cblx * cblz
        )
        - cbcx * sbcz * (
            (saly * salz + caly * calz * salx) * (cblz * sbly - cbly * sblx * sblz)
            + (caly * salz - calz * salx * saly) * (cbly * cblz + sblx * sbly * sblz)
            - calx * calz * cblx * sblz
        )
    )
    acz = np.arctan2(srzcrx / np.cos(acx), crzcrx / np.cos(acx))
    return np.array([acx, acy, acz])


def transform_associate_to_map(transform_sum, transform_bef, transform_aft):
    """src/laserMapping.cpp:110-197 / src/transformMaintenance.cpp:60-145:
    rotation via plugin_imu_rotation_ref, translation transcription."""
    ts = transform_sum
    tb = transform_bef
    ta = transform_aft

    x1 = np.cos(ts[1]) * (tb[3] - ts[3]) - np.sin(ts[1]) * (tb[5] - ts[5])
    y1 = tb[4] - ts[4]
    z1 = np.sin(ts[1]) * (tb[3] - ts[3]) + np.cos(ts[1]) * (tb[5] - ts[5])
    x2 = x1
    y2 = np.cos(ts[0]) * y1 + np.sin(ts[0]) * z1
    z2 = -np.sin(ts[0]) * y1 + np.cos(ts[0]) * z1
    incre3 = np.cos(ts[2]) * x2 + np.sin(ts[2]) * y2
    incre4 = -np.sin(ts[2]) * x2 + np.cos(ts[2]) * y2
    incre5 = z2

    rot = plugin_imu_rotation_ref(
        ts[0], ts[1], ts[2], tb[0], tb[1], tb[2], ta[0], ta[1], ta[2]
    )

    x1 = np.cos(rot[2]) * incre3 - np.sin(rot[2]) * incre4
    y1 = np.sin(rot[2]) * incre3 + np.cos(rot[2]) * incre4
    z1 = incre5
    x2 = x1
    y2 = np.cos(rot[0]) * y1 - np.sin(rot[0]) * z1
    z2 = np.sin(rot[0]) * y1 + np.cos(rot[0]) * z1
    t3 = ta[3] - (np.cos(rot[1]) * x2 + np.sin(rot[1]) * z2)
    t4 = ta[4] - y2
    t5 = ta[5] - (-np.sin(rot[1]) * x2 + np.cos(rot[1]) * z2)
    return np.concatenate([rot, [t3, t4, t5]])
