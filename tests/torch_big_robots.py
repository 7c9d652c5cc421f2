"""Humanoids above 28 joints for the port's tests and chip_smoke.py: atlas
with hands.

``atlas_hands_urdf(k)`` takes the port's ``zoo.atlas_urdf()`` and adds k
revolute joints to each of ``l_hand`` and ``r_hand``: four fingers of k // 4
joints where k is a multiple of 4 (k = 12 gives atlas_hands52, the DARPA
Robotics Challenge Atlas with two Sandia hands of four three-joint fingers:
28 + 24 = 52 joints), else one gripper of k joints (k = 3 gives
atlas_grippers34). A finger's first joint turns about x, the others about
y. Its links are light (0.2 kg at the hand down to 0.05 kg at the tip,
diagonal inertias), and every joint has atlas's own damping (0.1) and
limits (+-1.5).

Both packages parse the same string with their own ``parse_urdf``. This
module imports only the port (chip_smoke.py loads it by file path, where no
JAX is installed).
"""

from gridcodegenerator_tpu_torch.models import zoo

# a finger link's mass by its place from the hand, and its diagonal inertia
# (kg m^2; the distal links' set the stiffest mode of the joint damping)
MASSES = (0.2, 0.1, 0.05)
INERTIA = 4e-4
DAMPING, LIMIT = 0.1, 1.5


def atlas_hands_name(k: int) -> str:
    return (f"atlas_hands{28 + 2 * k}" if k % 4 == 0
            else f"atlas_grippers{28 + 2 * k}")


def atlas_hands_urdf(k: int) -> str:
    """atlas with k joints on each hand (see the module's docstring)."""
    fingers, length = (4, k // 4) if k % 4 == 0 else (1, k)
    parts = []
    for side, sy in (("l", 1.0), ("r", -1.0)):
        for f in range(fingers):
            prev = f"{side}_hand"
            # the fingers side by side across the palm, 3 cm apart
            org = (0.03 * f - 0.045 * (fingers - 1) / 3, sy * 0.1, 0.0)
            for j in range(length):
                link = f"{side}_finger{f}_{j}"
                m = MASSES[min(j, len(MASSES) - 1)]
                parts.append(zoo._link(link, m, (0, sy * 0.02, 0), INERTIA,
                                       INERTIA, INERTIA))
                axis = (1, 0, 0) if j == 0 else (0, 1, 0)
                parts.append(zoo._joint(f"{link}_j", "revolute", prev, link,
                                        org, (0, 0, 0), axis, DAMPING, -LIMIT,
                                        LIMIT))
                prev, org = link, (0.0, sy * 0.04, 0.0)
    base = zoo.atlas_urdf().replace('<robot name="atlas">',
                                    f'<robot name="{atlas_hands_name(k)}">')
    return base.replace("</robot>", "\n".join(parts) + "\n</robot>")
