#!/usr/bin/env python3
"""TD3 through the Gymnasium adapter — the reference's own DRL success path.

The reference trains AC-Gym's TD3 (a torch implementation of Fujimoto et
al. 2018) against `gym.make('gym_copter:Lander-v0')` with `--target 300`
(/root/reference/attic/drl/Makefile:1-8, attic/drl/README.md:10).  This
script reproduces that stack end-to-end against THIS framework's adapter:
a genuine external-style torch learner that only ever touches
`gymnasium.make('GymCopterTpu/<env>')` — proving a third-party consumer of
the reference can switch frameworks and train unchanged.

The TD3 implementation is faithful to the paper (and to AC-Gym's defaults):
twin critics, delayed policy updates (freq 2), target-policy smoothing
(sigma 0.2, clip 0.5), tau 0.005, batch 256, uniform replay, Gaussian
exploration noise 0.1, and a random-action warmup.

Usage:
  python scripts/td3_learn.py --env Lander2D-v0 --target 300 \
      --out docs/td3_lander2d.json
"""

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

# the adapter's JAX side runs the single env on CPU: one B=1 env step is
# dispatch-latency-bound, and this leaves the accelerator free for PPO runs
import jax
jax.config.update('jax_platforms', 'cpu')

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.nn as nn
import torch.nn.functional as F

import gymnasium


class Actor(nn.Module):
    def __init__(self, obs_dim, act_dim):
        super().__init__()
        self.l1 = nn.Linear(obs_dim, 256)
        self.l2 = nn.Linear(256, 256)
        self.l3 = nn.Linear(256, act_dim)

    def forward(self, s):
        h = F.relu(self.l1(s))
        h = F.relu(self.l2(h))
        return torch.tanh(self.l3(h))


class Critic(nn.Module):
    """Twin Q networks (TD3's clipped double-Q)."""

    def __init__(self, obs_dim, act_dim):
        super().__init__()
        self.q1 = nn.Sequential(nn.Linear(obs_dim + act_dim, 256), nn.ReLU(),
                                nn.Linear(256, 256), nn.ReLU(),
                                nn.Linear(256, 1))
        self.q2 = nn.Sequential(nn.Linear(obs_dim + act_dim, 256), nn.ReLU(),
                                nn.Linear(256, 256), nn.ReLU(),
                                nn.Linear(256, 1))

    def forward(self, s, a):
        sa = torch.cat([s, a], dim=1)
        return self.q1(sa), self.q2(sa)


class ReplayBuffer:
    def __init__(self, obs_dim, act_dim, size):
        self.size, self.ptr, self.full = size, 0, False
        self.s = np.zeros((size, obs_dim), np.float32)
        self.a = np.zeros((size, act_dim), np.float32)
        self.r = np.zeros((size, 1), np.float32)
        self.s2 = np.zeros((size, obs_dim), np.float32)
        self.nd = np.zeros((size, 1), np.float32)

    def add(self, s, a, r, s2, done):
        i = self.ptr
        self.s[i], self.a[i], self.r[i], self.s2[i] = s, a, r, s2
        self.nd[i] = 1.0 - float(done)
        self.ptr = (i + 1) % self.size
        self.full = self.full or self.ptr == 0

    def sample(self, batch, rng, norm=None):
        hi = self.size if self.full else self.ptr
        idx = rng.integers(0, hi, size=batch)
        s, s2 = self.s[idx], self.s2[idx]
        if norm is not None:
            # raw obs in the buffer, normalized with CURRENT stats at
            # sample time (the standard running-normalizer arrangement)
            s, s2 = norm(s), norm(s2)
        t = torch.as_tensor
        return (t(s), t(self.a[idx]), t(self.r[idx]),
                t(s2), t(self.nd[idx]))


class TD3:
    def __init__(self, obs_dim, act_dim, *, gamma=0.99, tau=0.005,
                 policy_noise=0.2, noise_clip=0.5, policy_freq=2, lr=3e-4):
        self.actor = Actor(obs_dim, act_dim)
        self.actor_t = copy.deepcopy(self.actor)
        self.critic = Critic(obs_dim, act_dim)
        self.critic_t = copy.deepcopy(self.critic)
        self.a_opt = torch.optim.Adam(self.actor.parameters(), lr=lr)
        self.c_opt = torch.optim.Adam(self.critic.parameters(), lr=lr)
        self.gamma, self.tau = gamma, tau
        self.policy_noise, self.noise_clip = policy_noise, noise_clip
        self.policy_freq = policy_freq
        self.it = 0

    def act(self, obs):
        with torch.no_grad():
            obs = torch.from_numpy(np.array(obs, dtype=np.float32))
            return self.actor(obs[None])[0].numpy()

    def train_step(self, buffer, batch, rng, norm=None):
        self.it += 1
        s, a, r, s2, nd = buffer.sample(batch, rng, norm)
        with torch.no_grad():
            noise = (torch.randn_like(a) * self.policy_noise
                     ).clamp(-self.noise_clip, self.noise_clip)
            a2 = (self.actor_t(s2) + noise).clamp(-1.0, 1.0)
            q1t, q2t = self.critic_t(s2, a2)
            target = r + nd * self.gamma * torch.min(q1t, q2t)
        q1, q2 = self.critic(s, a)
        c_loss = F.mse_loss(q1, target) + F.mse_loss(q2, target)
        self.c_opt.zero_grad()
        c_loss.backward()
        self.c_opt.step()

        if self.it % self.policy_freq == 0:
            a_loss = -self.critic(s, self.actor(s))[0].mean()
            self.a_opt.zero_grad()
            a_loss.backward()
            self.a_opt.step()
            for p, pt in zip(self.actor.parameters(),
                             self.actor_t.parameters()):
                pt.data.mul_(1 - self.tau).add_(self.tau * p.data)
            for p, pt in zip(self.critic.parameters(),
                             self.critic_t.parameters()):
                pt.data.mul_(1 - self.tau).add_(self.tau * p.data)


class ObsNormalizer:
    """Running mean/std observation normalizer (the standard DRL-harness
    tweak AC-Gym-era stacks apply; Welford accumulation, stats frozen for
    evaluation reads — updated only on training-env steps)."""

    def __init__(self, dim, eps=1e-8):
        self.n = 0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.ones(dim, np.float64)
        self.eps = eps

    def update(self, x):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    def __call__(self, x):
        if self.n < 2:
            return np.asarray(x, np.float32)
        std = np.sqrt(self.m2 / (self.n - 1)) + self.eps
        return ((x - self.mean) / std).astype(np.float32)


def evaluate(env, agent, episodes=10, norm=None):
    total = 0.0
    for ep in range(episodes):
        obs, _ = env.reset(seed=10_000 + ep)
        done = False
        while not done:
            o = norm(obs) if norm else obs
            obs, r, term, trunc, _ = env.step(agent.act(o))
            total += r
            done = term or trunc
    return total / episodes


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--env', default='Lander2D-v0')
    p.add_argument('--target', type=float, default=300.0,
                   help='stop when eval return reaches this '
                        '(attic/drl/Makefile:2)')
    p.add_argument('--max-steps', type=int, default=300_000)
    p.add_argument('--start-steps', type=int, default=10_000)
    p.add_argument('--expl-noise', type=float, default=0.1)
    p.add_argument('--obs-norm', action='store_true',
                   help='running mean/std observation normalization '
                        '(standard AC-Gym-era harness tweak; off = the '
                        'faithful bare recipe)')
    p.add_argument('--noise-decay-to', type=float, default=0.0,
                   help='if > 0, linearly decay exploration noise from '
                        '--expl-noise to this value over the run')
    p.add_argument('--batch', type=int, default=256)
    p.add_argument('--eval-every', type=int, default=5_000)
    p.add_argument('--eval-episodes', type=int, default=10)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--vehicle', choices=['attic', 'active'], default='attic',
                   help="'attic' (B=5e-6, hover throttle ~0.52) is the "
                        "vehicle the reference's TD3 Makefile era actually "
                        "trained on (attic/mars/dynamics/djiphantom.py:51); "
                        "the active B=5e-3 puts hover at motor 0.0166 — a "
                        "sliver of the [-1,1] action range no [-1,1]-"
                        "normalized learner conditions well on")
    p.add_argument('--out', default='docs/td3_lander2d.json')
    p.add_argument('--checkpoint', default=None,
                   help='torch .pt file for the best policy '
                        '(the Makefile\'s --checkpoint)')
    p.add_argument('--state-checkpoint', default=None,
                   help='full training-state .pt (nets, targets, '
                        'optimizers, replay buffer, RNG states, normalizer, '
                        'step/curve) written at every eval — enables '
                        '--resume after a kill (the round-5 1M runs had to '
                        'restart from scratch without this)')
    p.add_argument('--resume', action='store_true',
                   help='continue from --state-checkpoint if it exists.  '
                        'Learner state (nets/optimizers/buffer/RNG) resumes '
                        'exactly; the environment stream restarts from a '
                        'fresh reset (documented deviation: the adapter env '
                        'is not serialized), so the post-resume data stream '
                        'differs from an uninterrupted run')
    args = p.parse_args()

    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    import gym_copter_tpu.compat.gym_adapter  # registers GymCopterTpu ids
    make_kwargs = {}
    if args.vehicle == 'attic':
        from gym_copter_tpu.core import vehicles
        from gym_copter_tpu.core.types import EnvParams
        make_kwargs['params'] = EnvParams(vehicle=vehicles.DJI_PHANTOM_ATTIC)
    env = gymnasium.make(f'GymCopterTpu/{args.env}', **make_kwargs)
    eval_env = gymnasium.make(f'GymCopterTpu/{args.env}', **make_kwargs)
    obs_dim = env.observation_space.shape[0]
    act_dim = env.action_space.shape[0]

    agent = TD3(obs_dim, act_dim)
    buffer = ReplayBuffer(obs_dim, act_dim, size=args.max_steps)

    norm = ObsNormalizer(obs_dim) if args.obs_norm else None

    curve, best = [], -float('inf')
    start_step, episodes = 0, 0
    if args.resume and args.state_checkpoint \
            and os.path.exists(args.state_checkpoint):
        ck = torch.load(args.state_checkpoint, weights_only=False)
        agent.actor.load_state_dict(ck['actor'])
        agent.actor_t.load_state_dict(ck['actor_t'])
        agent.critic.load_state_dict(ck['critic'])
        agent.critic_t.load_state_dict(ck['critic_t'])
        agent.a_opt.load_state_dict(ck['a_opt'])
        agent.c_opt.load_state_dict(ck['c_opt'])
        agent.it = ck['it']
        saved = ck['buffer']
        ssize = saved['s'].shape[0]
        valid = ssize if saved['full'] else saved['ptr']
        n = min(valid, buffer.size)
        # most recent n transitions in chronological order (the new
        # --max-steps may differ from the saved run's, resizing the buffer)
        if saved['full']:
            order = (np.arange(saved['ptr'], saved['ptr'] + ssize) % ssize)
        else:
            order = np.arange(valid)
        take = order[valid - n:]
        for name in ('s', 'a', 'r', 's2', 'nd'):
            getattr(buffer, name)[:n] = saved[name][take]
        buffer.ptr, buffer.full = n % buffer.size, n == buffer.size
        torch.set_rng_state(ck['torch_rng'])
        rng.bit_generator.state = ck['np_rng']
        if norm is not None and ck.get('norm') is not None:
            norm.n, norm.mean, norm.m2 = ck['norm']
        curve, best = ck['curve'], ck['best']
        start_step, episodes = ck['step'], ck['episodes']
        print(f'resumed from {args.state_checkpoint} at step {start_step} '
              f'(best eval {best:.1f})', flush=True)

    def save_state(step):
        if not args.state_checkpoint:
            return
        torch.save({
            'actor': agent.actor.state_dict(),
            'actor_t': agent.actor_t.state_dict(),
            'critic': agent.critic.state_dict(),
            'critic_t': agent.critic_t.state_dict(),
            'a_opt': agent.a_opt.state_dict(),
            'c_opt': agent.c_opt.state_dict(),
            'it': agent.it,
            'buffer': {'s': buffer.s, 'a': buffer.a, 'r': buffer.r,
                       's2': buffer.s2, 'nd': buffer.nd,
                       'ptr': buffer.ptr, 'full': buffer.full},
            'torch_rng': torch.get_rng_state(),
            'np_rng': rng.bit_generator.state,
            'norm': (norm.n, norm.mean, norm.m2) if norm else None,
            'curve': curve, 'best': best,
            'step': step, 'episodes': episodes,
        }, args.state_checkpoint)

    obs, _ = env.reset(seed=args.seed + episodes)
    ep_ret, ep_len = 0.0, 0
    t0 = time.time()
    for step in range(start_step + 1, args.max_steps + 1):
        if norm:
            norm.update(np.asarray(obs, np.float64))
        if args.noise_decay_to > 0:
            frac = step / args.max_steps
            noise_sigma = (args.expl_noise
                           + frac * (args.noise_decay_to - args.expl_noise))
        else:
            noise_sigma = args.expl_noise
        if step <= args.start_steps:
            action = env.action_space.sample()
        else:
            action = np.clip(
                agent.act(norm(obs) if norm else obs)
                + rng.normal(0, noise_sigma, size=act_dim), -1, 1
            ).astype(np.float32)
        obs2, r, term, trunc, _ = env.step(action)
        buffer.add(obs, action, r, obs2, term and not trunc)
        obs = obs2
        ep_ret += r
        ep_len += 1
        if term or trunc:
            obs, _ = env.reset(seed=args.seed + episodes + 1)
            episodes += 1
            ep_ret, ep_len = 0.0, 0
        if step > args.start_steps:
            agent.train_step(buffer, args.batch, rng, norm=norm)
        if step % args.eval_every == 0:
            ret = evaluate(eval_env, agent, args.eval_episodes, norm=norm)
            curve.append({'step': step, 'eval_return': float(ret)})
            print(f'step {step:7d}  eval {ret:8.2f}  '
                  f'({step / (time.time() - t0):.0f} steps/s)', flush=True)
            if ret > best:
                best = ret
                if args.checkpoint:
                    torch.save(agent.actor.state_dict(), args.checkpoint)
            save_state(step)
            if ret >= args.target:
                print(f'target {args.target} reached at step {step}')
                break

    summary = {
        'env': args.env, 'seed': args.seed, 'target': args.target,
        'obs_norm': bool(args.obs_norm),
        'noise_decay_to': args.noise_decay_to,
        'best_eval_return': best, 'steps': curve[-1]['step'] if curve else 0,
        'reached_target': best >= args.target,
        'wall_seconds': time.time() - t0,
        'curve': curve,
    }
    with open(args.out, 'w') as f:
        json.dump(summary, f, indent=1)
    print('wrote', args.out, '| best eval', round(best, 1))


if __name__ == '__main__':
    main()
