"""Model zoo: the bundled robot topologies, numpy only.

A copy of ``gridcodegenerator_tpu/models/zoo.py`` (see ``topology/robot.py``
for why it is copied). The inline robots emit URDF strings; the vendor URDFs
are the port's own copies of the JAX package's ``models/vendor/`` files, in
``models/vendor/`` here (byte for byte the same: tests/test_torch_model.py).

* ``iiwa``      — 7-DoF revolute serial chain in the KUKA iiwa14 layout
* ``iiwa14``    — the vendor iiwa14 URDF
* ``hyq``       — 12-DoF branched quadruped
* ``atlas``     — 28-DoF branched humanoid
* ``pendulum2``/``pendulum4`` — chains for hand-checkable tests
* ``mixed5``    — revolute x/y/z, prismatic and a skew-axis joint
* ``*_floating``— floating-base variants
"""

from __future__ import annotations

import functools
import math
import os
from typing import List

from ..topology.robot import RobotTopology
from ..topology.urdf import parse_urdf

PI = math.pi
VENDOR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "vendor")


def _link(name, mass, com, ixx, iyy, izz, ixy=0.0, ixz=0.0, iyz=0.0) -> str:
    return f"""  <link name="{name}">
    <inertial>
      <origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="{ixx}" ixy="{ixy}" ixz="{ixz}" iyy="{iyy}" iyz="{iyz}" izz="{izz}"/>
    </inertial>
  </link>"""


def _joint(name, jtype, parent, child, xyz, rpy, axis=(0, 0, 1),
           damping=0.0, lower=None, upper=None) -> str:
    lim = ""
    if lower is not None:
        lim = f'\n    <limit lower="{lower}" upper="{upper}" effort="300" velocity="10"/>'
    ax = "" if jtype == "fixed" else f'\n    <axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>'
    dmp = f'\n    <dynamics damping="{damping}"/>' if damping else ""
    return f"""  <joint name="{name}" type="{jtype}">
    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/>
    <parent link="{parent}"/>
    <child link="{child}"/>{ax}{dmp}{lim}
  </joint>"""


def _urdf(name: str, parts: List[str]) -> str:
    body = "\n".join(parts)
    return f'<robot name="{name}">\n{body}\n</robot>\n'


def iiwa_urdf() -> str:
    """7-DoF revolute serial chain in the KUKA iiwa14 layout, with an
    end-effector fixed joint target."""
    J = [  # (xyz, rpy)
        ((0, 0, 0.1575), (0, 0, 0)),
        ((0, 0, 0.2025), (PI / 2, 0, PI)),
        ((0, 0.2045, 0), (PI / 2, 0, PI)),
        ((0, 0, 0.2155), (PI / 2, 0, 0)),
        ((0, 0.1845, 0), (-PI / 2, PI, 0)),
        ((0, 0, 0.2155), (PI / 2, 0, 0)),
        ((0, 0.081, 0), (-PI / 2, PI, 0)),
    ]
    M = [4.0, 4.0, 3.0, 2.7, 1.7, 1.8, 0.3]
    COM = [(0, -0.03, 0.12), (0.0003, 0.059, 0.042), (0, 0.03, 0.13),
           (0, 0.067, 0.034), (0.0001, 0.021, 0.076), (0, 0.0006, 0.0004),
           (0, 0, 0.02)]
    I3 = [(0.1, 0.09, 0.02), (0.05, 0.018, 0.044), (0.08, 0.075, 0.01),
          (0.03, 0.01, 0.029), (0.02, 0.018, 0.005), (0.005, 0.0036, 0.0047),
          (0.001, 0.001, 0.001)]
    parts = [_link("base", 5.0, (0, 0, 0.05), 0.05, 0.06, 0.03)]
    prev = "base"
    for i in range(7):
        ln = f"link{i + 1}"
        parts.append(_link(ln, M[i], COM[i], *I3[i]))
        parts.append(_joint(
            f"joint{i + 1}", "revolute", prev, ln, J[i][0], J[i][1],
            axis=(0, 0, 1), damping=0.1,
            lower=-2.96 if i % 2 == 0 else -2.09,
            upper=2.96 if i % 2 == 0 else 2.09))
        prev = ln
    parts.append(_link("ee", 0.0, (0, 0, 0), 0, 0, 0))
    parts.append(_joint("ee_fixed", "fixed", "link7", "ee",
                        (0, 0, 0.045), (0, 0, 0)))
    return _urdf("iiwa", parts)


def hyq_urdf() -> str:
    """12-DoF branched quadruped: 4 legs x [HAA(x), HFE(y), KFE(y)]."""
    parts = [_link("trunk", 60.0, (0, 0, 0), 1.5, 8.5, 9.0)]
    hips = {"lf": (0.3735, 0.207), "rf": (0.3735, -0.207),
            "lh": (-0.3735, 0.207), "rh": (-0.3735, -0.207)}
    for leg, (hx, hy) in sorted(hips.items()):
        hip, upper, lower, foot = (f"{leg}_hip", f"{leg}_upper",
                                   f"{leg}_lower", f"{leg}_foot")
        parts.append(_link(hip, 3.0, (0, 0.08 * (1 if hy > 0 else -1), 0),
                           0.005, 0.01, 0.01))
        parts.append(_joint(f"{leg}_haa", "revolute", "trunk", hip,
                            (hx, hy, 0), (0, 0, 0), axis=(1, 0, 0),
                            damping=0.5, lower=-1.22, upper=0.44))
        parts.append(_link(upper, 3.3, (0.15, 0, -0.03), 0.005, 0.05, 0.05))
        parts.append(_joint(f"{leg}_hfe", "revolute", hip, upper,
                            (0, 0.08 * (1 if hy > 0 else -1), 0), (0, 0, 0),
                            axis=(0, 1, 0), damping=0.5, lower=-0.87, upper=1.22))
        parts.append(_link(lower, 0.9, (0.12, 0, -0.02), 0.001, 0.01, 0.01))
        parts.append(_joint(f"{leg}_kfe", "revolute", upper, lower,
                            (0.35, 0, 0), (0, 0, 0), axis=(0, 1, 0),
                            damping=0.5, lower=-2.44, upper=-0.25))
        parts.append(_link(foot, 0.0, (0, 0, 0), 0, 0, 0))
        parts.append(_joint(f"{leg}_foot_fixed", "fixed", lower, foot,
                            (0.35, 0, 0), (0, 0, 0)))
    return _urdf("hyq", parts)


def atlas_urdf() -> str:
    """28-DoF branched humanoid (torso, neck, arms, legs)."""
    parts = [_link("pelvis", 17.8, (0.01, 0, 0.02), 0.12, 0.1, 0.1)]
    parts.append(_link("ltorso", 2.4, (-0.01, 0, 0.05), 0.004, 0.004, 0.004))
    parts.append(_joint("back_bkz", "revolute", "pelvis", "ltorso",
                        (-0.0125, 0, 0), (0, 0, 0), (0, 0, 1), 0.1, -0.66, 0.66))
    parts.append(_link("mtorso", 0.7, (-0.008, -0.01, 0.16), 0.0005, 0.0005, 0.0005))
    parts.append(_joint("back_bky", "revolute", "ltorso", "mtorso",
                        (0, 0, 0.162), (0, 0, 0), (0, 1, 0), 0.1, -0.22, 0.54))
    parts.append(_link("utorso", 52.0, (-0.08, 0, 0.3), 1.5, 1.5, 0.6))
    parts.append(_joint("back_bkx", "revolute", "mtorso", "utorso",
                        (0, 0, 0.05), (0, 0, 0), (1, 0, 0), 0.1, -0.52, 0.52))
    parts.append(_link("head", 1.4, (-0.08, 0, 0.09), 0.005, 0.006, 0.009))
    parts.append(_joint("neck_ry", "revolute", "utorso", "head",
                        (0.22, 0, 0.53), (0, 0, 0), (0, 1, 0), 0.1, -0.6, 1.14))
    for side, sy in (("l", 1.0), ("r", -1.0)):
        names = [f"{side}_{nm}" for nm in
                 ("clav", "scap", "uarm", "larm", "farm", "hand")]
        jnames = [f"{side}_arm_{nm}" for nm in
                  ("shz", "shx", "ely", "elx", "wry", "wrx")]
        axes = [(0, 0, 1), (1, 0, 0), (0, 1, 0), (1, 0, 0), (0, 1, 0), (1, 0, 0)]
        orgs = [(0.14, sy * 0.22, 0.38), (0, sy * 0.075, 0.036),
                (0, sy * 0.185, 0), (0.119, sy * 0.0092, 0.0093),
                (0.0, sy * 0.187, -0.0093), (0.1, sy * 0.01, 0)]
        masses = [4.5, 3.9, 3.0, 2.5, 1.0, 0.5]
        prev = "utorso"
        for k in range(6):
            parts.append(_link(names[k], masses[k], (0, sy * 0.04, 0),
                               0.011, 0.009, 0.004))
            parts.append(_joint(jnames[k], "revolute", prev, names[k],
                                orgs[k], (0, 0, 0), axes[k], 0.1, -1.5, 1.5))
            prev = names[k]
    for side, sy in (("l", 1.0), ("r", -1.0)):
        names = [f"{side}_{nm}" for nm in
                 ("uglut", "lglut", "uleg", "lleg", "talus", "foot")]
        jnames = [f"{side}_leg_{nm}" for nm in
                  ("hpz", "hpx", "hpy", "kny", "aky", "akx")]
        axes = [(0, 0, 1), (1, 0, 0), (0, 1, 0), (0, 1, 0), (0, 1, 0), (1, 0, 0)]
        orgs = [(0, sy * 0.089, 0), (0, 0, 0), (0.05, sy * 0.0225, -0.066),
                (-0.05, 0, -0.374), (0, 0, -0.422), (0, 0, 0)]
        masses = [1.0, 0.9, 8.2, 4.5, 0.1, 2.4]
        prev = "pelvis"
        for k in range(6):
            parts.append(_link(names[k], masses[k], (0, 0, -0.1),
                               0.09, 0.09, 0.02))
            parts.append(_joint(jnames[k], "revolute", prev, names[k],
                                orgs[k], (0, 0, 0), axes[k], 0.1, -1.6, 1.6))
            prev = names[k]
        parts.append(_link(f"{side}_sole", 0.0, (0, 0, 0), 0, 0, 0))
        parts.append(_joint(f"{side}_sole_fixed", "fixed", f"{side}_foot",
                            f"{side}_sole", (0.05, 0, -0.09), (0, 0, 0)))
    return _urdf("atlas", parts)


def pendulum_urdf(n: int = 2) -> str:
    """n-link pendulum: unit links about y, point masses at link ends."""
    parts = [_link("base", 1.0, (0, 0, 0), 0.01, 0.01, 0.01)]
    prev = "base"
    for i in range(n):
        ln = f"link{i + 1}"
        parts.append(_link(ln, 1.0, (0.5, 0, 0), 1e-4, 1.0 / 12, 1.0 / 12))
        parts.append(_joint(f"joint{i + 1}", "continuous", prev, ln,
                            (1.0 if i else 0.0, 0, 0), (0, 0, 0), (0, 1, 0)))
        prev = ln
    return _urdf(f"pendulum{n}", parts)


def mixed_chain_urdf() -> str:
    """5-DoF chain mixing revolute x/y/z and prismatic joints plus a
    skew-axis joint."""
    parts = [_link("base", 1.0, (0, 0, 0), 0.01, 0.01, 0.01)]
    specs = [("revolute", (1, 0, 0)), ("revolute", (0, 1, 0)),
             ("prismatic", (0, 0, 1)), ("revolute", (0, 0.6, 0.8)),
             ("prismatic", (1, 0, 0))]
    prev = "base"
    for i, (t, ax) in enumerate(specs):
        ln = f"link{i + 1}"
        parts.append(_link(ln, 1.0 + 0.2 * i, (0.1, 0.05, 0.2),
                           0.02, 0.03, 0.015, ixy=0.002, iyz=0.001))
        parts.append(_joint(f"j{i + 1}", t, prev, ln,
                            (0.1 * i, 0.05, 0.2), (0.1, -0.2, 0.3), ax,
                            damping=0.05 * i, lower=-2.0, upper=2.0))
        prev = ln
    return _urdf("mixed5", parts)


def _vendor_urdf(fname: str) -> str:
    with open(os.path.join(VENDOR_DIR, fname)) as f:
        return f.read()


_URDF_SOURCES = {
    "iiwa": iiwa_urdf,
    "iiwa14": lambda: _vendor_urdf("iiwa14.urdf"),
    "hyq": hyq_urdf,
    "atlas": atlas_urdf,
    "gym_ant": lambda: _vendor_urdf("gym_ant.urdf"),
    "gym_humanoid": lambda: _vendor_urdf("gym_humanoid.urdf"),
    "dm_quadruped": lambda: _vendor_urdf("dm_quadruped.urdf"),
    "pendulum2": lambda: pendulum_urdf(2),
    "pendulum4": lambda: pendulum_urdf(4),
    "mixed5": mixed_chain_urdf,
}


def list_robots() -> List[str]:
    names = sorted(_URDF_SOURCES)
    return names + [n + "_floating" for n in names]


@functools.lru_cache(maxsize=None)
def load_robot(name: str) -> RobotTopology:
    """Load a bundled robot by name; append ``_floating`` for a floating base."""
    floating = name.endswith("_floating")
    base = name[:-len("_floating")] if floating else name
    if base not in _URDF_SOURCES:
        raise KeyError(f"unknown robot {name!r}; have {list_robots()}")
    return parse_urdf(_URDF_SOURCES[base](), floating_base=floating, name=name)


def robot_urdf(name: str) -> str:
    """The URDF string of a bundled robot (``_floating`` names give their
    fixed-base robot's)."""
    base = name[:-len("_floating")] if name.endswith("_floating") else name
    return _URDF_SOURCES[base]()
