"""Frozen parameter pytrees for the batched copter engine.

The reference passes vehicle constants as a plain dict
(gym_copter/dynamics/vehicles/dji_phantom.py:9-26) and task settings as
constructor kwargs + class constants (gym_copter/envs/task.py:32-38,
gym_copter/envs/lander.py:17-23).  Here everything is a NamedTuple so the
whole configuration is a JAX pytree: it can be closed over statically or
traced/donated, and it is trivially checkpointable.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from gym_copter_tpu.core import constants as C


class VehicleParams(NamedTuple):
    """Bouabdallah-2004 vehicle constants.

    Field meanings follow the reference dynamics constructor
    (gym_copter/dynamics/__init__.py:85-95).
    """

    B: float       # thrust coefficient [F = B * w^2]
    D: float       # torque (drag) coefficient [T = D * w^2]
    M: float       # mass [kg]
    L: float       # arm length [m]
    Ix: float      # moment of inertia about X [kg m^2]
    Iy: float      # moment of inertia about Y [kg m^2]
    Iz: float      # moment of inertia about Z [kg m^2]
    Jr: float      # rotor inertia [kg m^2]
    maxrpm: float  # maximum motor speed [rpm]
    C_L: float = 0.4  # lift coefficient, blade-element model only
                      # (attic/mars/dynamics/ingenuity.py:60-62)


class WorldParams(NamedTuple):
    """World constants; the active reference hardcodes Earth gravity
    (gym_copter/dynamics/__init__.py:76), the attic makes {G, rho}
    injectable (attic/mars/dynamics/__init__.py:83-84)."""

    g: float = C.EARTH_G
    rho: float = C.EARTH_RHO


class TaskParams(NamedTuple):
    """Task-level settings; defaults match the reference
    (gym_copter/envs/task.py:25,32-38)."""

    dt: float = 0.01                      # 1 / FRAMES_PER_SECOND (=100)
    initial_random_force: float = 30.0
    out_of_bounds_penalty: float = 100.0
    max_steps: int = 1000
    max_angle: float = math.radians(45.0)
    bounds: float = 10.0
    initial_altitude: float = 10.0
    # auxiliary-task constants (attic):
    althold_target: float = 10.0          # attic/gym_copter/envs/althold.py:21
    althold_tolerance: float = 1.0
    takeoff_target: float = 5.0           # attic/gym_copter/envs/takeoff.py (TARGET_ALTITUDE)
    target_orbit_radius: float = 10.0     # attic/gym_copter/envs/target.py:44-47
    target_dtheta: float = 0.0025
    target_altitude: float = 10.0         # target.py:68


class LanderRewardParams(NamedTuple):
    """Landing-task shaping constants (gym_copter/envs/lander.py:17-23)."""

    target_radius: float = 2.0
    yaw_penalty_factor: float = 50.0
    xyz_penalty_factor: float = 25.0
    dz_max: float = 10.0
    dz_penalty: float = 100.0
    inside_radius_bonus: float = 100.0
    # attic simple 3D lander: heavier penalty over roll/pitch angles and
    # rates, state rows 6:10 (simple_lander3d.py:25-26)
    pitch_roll_penalty_factor: float = 250.0


class EnvParams(NamedTuple):
    """Full environment configuration pytree passed into the pure step.

    lift_model: 'bouabdallah' — Eq.6 thrust B*w^2 with Omega=0 (the active
    dynamics, gym_copter/dynamics/__init__.py:114-135) — or
    'blade_element' — the attic mars variant: per-motor lift
    0.5*rho*S*C_L*(w*L/2)^2 with S=0.05*L*4 and a live rotor-disturbance
    term Omega=u4(omegas) feeding the Jr gyroscopic terms
    (attic/mars/dynamics/__init__.py:135-164, 280-289).
    """

    vehicle: VehicleParams
    world: WorldParams = WorldParams()
    task: TaskParams = TaskParams()
    reward: LanderRewardParams = LanderRewardParams()
    lift_model: str = 'bouabdallah'
