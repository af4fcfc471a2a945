from setuptools import find_packages, setup

setup(
    name='gym_copter_tpu',
    version='0.1.0',
    description='Batched multicopter RL environment engine (JAX/XLA)',
    packages=find_packages(include=['gym_copter_tpu*']),
    python_requires='>=3.10',
    install_requires=['jax', 'numpy'],
)
