#!/usr/bin/env python3
"""Heuristic landing demo — the batched analogue of the reference's
top-level lander.py.

Runs the constant-thrust heuristic (MOTORVAL=1.625e-2, lander.py:21) on
Lander-v0, optionally saving a reference-format CSV trajectory, an MP4
movie, or displaying the 3D matplotlib animation.  Unlike the reference —
which steps the sim on a worker thread while matplotlib animates the shared
mutable pose (rendering/__init__.py:149,237-240) — the simulation here runs
to completion as one jitted rollout and the renderer replays the recorded
trajectory, so there is no data race and no real-time pacing in the sim.

Usage:
  python lander_demo.py                      # animate the landing
  python lander_demo.py --save traj.csv      # save CSV (copter-plot format)
  python lander_demo.py --movie              # save movie.mp4
  python lander_demo.py --nodisplay          # headless: just print stats
  python lander_demo.py --random --seed 7    # random motor values
  python lander_demo.py --freeze 2,1,8,10,0  # hold pose x,y,z,phi,theta
                                             # (reference demo_pose,
                                             # gym_copter/envs/lander.py:79-91)
  python lander_demo.py --vision             # downward-camera view per step
  python lander_demo.py --dvs                # event-camera view per step
                                             # (attic/mars/lander3d.py:112-140)
"""

import argparse
from argparse import ArgumentDefaultsHelpFormatter

import numpy as np

import jax
import jax.numpy as jnp

import gym_copter_tpu as gct
from gym_copter_tpu.render.csvlog import write_csv

MOTORVAL = 1.625e-2  # reference lander.py:21


def parse_view_angles(view):
    return tuple(int(s) for s in view.split(','))


def main():
    parser = argparse.ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument('--save', dest='csvfilename',
                        help='Save trajectory in CSV file')
    parser.add_argument('--movie', action='store_true',
                        help='Save movie in an MP4 file')
    parser.add_argument('--view', default='30,120',
                        help='Elevation, azimuth for view perspective')
    parser.add_argument('--random', action='store_true',
                        help='Use random motor values for comparison')
    parser.add_argument('--seed', type=int, default=0, help='Random seed')
    parser.add_argument('--nodisplay', action='store_true',
                        help='Run headless (no rendering)')
    parser.add_argument('--freeze', dest='pose', default=None,
                        help='Freeze in pose x,y,z,phi,theta (no physics)')
    sensors = parser.add_mutually_exclusive_group()
    sensors.add_argument('--vision', action='store_true',
                         help='Show the downward vision-sensor view')
    sensors.add_argument('--dvs', action='store_true',
                         help='Show the DVS event-camera view')
    parser.add_argument('--res', type=int, default=64,
                        help='Vision/DVS sensor resolution')
    args = parser.parse_args()

    env = gct.make('Lander-v0', num_envs=1, seed=args.seed)
    dt = env.params.task.dt

    if args.pose is not None:
        freeze_pose(env, args)
        return

    state, obs = env.reset()

    # Pre-script the action sequence, then run the whole episode as ONE
    # compiled rollout — no per-step host round-trips (the reference's
    # python loop at 100 Hz becomes a single lax.scan).
    T = env.params.task.max_steps + 1
    rng = np.random.default_rng(args.seed)
    if args.random:
        actions = MOTORVAL * rng.standard_normal((T, 4)).astype(np.float32)
    else:
        actions = MOTORVAL * np.ones((T, 4), np.float32)
    first_obs = obs
    state, traj = env.run_episode(state, jnp.asarray(actions)[:, :, None])

    done = np.asarray(traj.done[:, 0])
    end = int(done.argmax()) + 1 if done.any() else T
    rewards = np.asarray(traj.reward[:end, 0])
    # trajectory obs: initial obs + per-step obs (which are post-reset on
    # done steps, so stop at `end`)
    obs_log = np.concatenate(
        [np.asarray(first_obs).T, np.asarray(traj.obs[:end - 1, :, 0])])
    act_log = actions[:end]
    pose_log = np.asarray(traj.x[:end, (0, 2, 4, 6, 8, 10), 0])

    total_reward = 0.0
    for step in range(end):
        total_reward += float(rewards[step])
        print('steps =  %04d    total_reward = %+0.2f'
              % (step + 1, total_reward))

    if args.csvfilename:
        write_csv(args.csvfilename, dt * np.arange(len(obs_log)),
                  np.clip(act_log, 0, 1), obs_log,
                  ['X', 'dX', 'Y', 'dY', 'Z', 'dZ',
                   'Phi', 'dPhi', 'Theta', 'dTheta'])
        print('saved', args.csvfilename)

    if args.vision or args.dvs:
        show_sensor_view(pose_log, args, dt)
    elif not args.nodisplay or args.movie:
        from gym_copter_tpu.render.threed import ThreeDLanderRenderer
        renderer = ThreeDLanderRenderer(
            viewangles=parse_view_angles(args.view),
            target_radius=env.params.reward.target_radius)
        renderer.play(pose_log, fps=int(round(1 / dt)),
                      outfile='movie.mp4' if args.movie else None,
                      show=not args.nodisplay)


def freeze_pose(env, args):
    """Reference `demo_pose` freeze mode (gym_copter/envs/lander.py:79-91):
    reset to the given pose with no perturbation and hold it — a static
    pose viewer for checking vehicle orientation in the renderer."""
    try:
        x, y, z, phi, theta = (float(s) for s in args.pose.split(','))
    except ValueError:
        raise SystemExit('POSE must be x,y,z,phi,theta')
    state, obs = env.reset(pose=(x, y, z, phi, theta),
                           perturb_force=np.zeros((6, 1)))
    pose = np.asarray(state.dyn.x[(0, 2, 4, 6, 8, 10), 0])
    print('frozen pose (x, y, z, phi, theta, psi):',
          np.array2string(pose, precision=3))
    if not args.nodisplay or args.movie:
        from gym_copter_tpu.render.threed import ThreeDLanderRenderer
        renderer = ThreeDLanderRenderer(
            viewangles=parse_view_angles(args.view),
            target_radius=env.params.reward.target_radius)
        # hold the pose for 2 s of animation frames
        renderer.play(np.tile(pose, (200, 1)), fps=100,
                      outfile='movie.mp4' if args.movie else None,
                      show=not args.nodisplay)


def show_sensor_view(pose_log, args, dt):
    """Replay the trajectory through the vision / DVS sensor
    (attic/mars/lander3d.py --vision/--dvs flags; sensor math in
    gym_copter_tpu/sensors/vision.py)."""
    from gym_copter_tpu.sensors.vision import DVS, VisionSensor

    # pose_log is (T, 6) NED; the sensor wants (6, B) with positive
    # altitude and degree angles
    x12 = np.zeros((12, len(pose_log)), np.float32)
    x12[(0, 2, 4, 6, 8, 10), :] = pose_log.T

    if args.dvs:
        sensor = DVS(res=args.res)
        poses = sensor.pose_from_state(jnp.asarray(x12))
        frames_curr = np.asarray(sensor.get_images(poses))
        prev = np.concatenate([np.zeros_like(frames_curr[:1]),
                               frames_curr[:-1]])
        frames = np.sign(prev - frames_curr)
        events = int(np.abs(frames).sum())
        print(f'DVS: {len(frames)} frames, {events} events')
    else:
        sensor = VisionSensor(res=args.res)
        poses = sensor.pose_from_state(jnp.asarray(x12))
        frames = np.asarray(sensor.get_images(poses))
        print(f'vision: {len(frames)} frames, '
              f'{int(frames.sum())} lit pixels total')

    if args.nodisplay and not args.movie:
        return
    import matplotlib
    if args.nodisplay:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, ax = plt.subplots()
    ax.set_axis_off()
    kind = 'DVS events' if args.dvs else 'vision'
    ax.set_title(f'downward {kind} view')
    im = ax.imshow(frames[0], cmap='RdGy' if args.dvs else 'gray',
                   vmin=-1 if args.dvs else 0, vmax=1)

    def animate(i):
        im.set_data(frames[min(i, len(frames) - 1)])
        return [im]

    anim = animation.FuncAnimation(fig, animate, frames=len(frames),
                                   interval=1000 * dt, blit=True,
                                   repeat=False)
    if args.movie:
        out = 'sensor.mp4' if animation.FFMpegWriter.isAvailable() \
            else 'sensor.gif'
        anim.save(out, fps=int(round(1 / dt)))
        print('saved', out)
    if not args.nodisplay:
        plt.show()


if __name__ == '__main__':
    main()
