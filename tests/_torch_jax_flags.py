"""``jax_xla_flags``: the ``XLA_FLAGS`` every JAX oracle subprocess of the
port's tests runs under.  It imports neither JAX nor torch, so the oracle
scripts and the test files both import it."""


def jax_xla_flags(devices: int) -> str:
    """``XLA_FLAGS`` of a JAX oracle subprocess: ``devices`` simulated CPU
    devices, compiled with LLVM's cheaper passes (the checks compile many
    small steps, and the compile, not the run, is their cost), each
    device's ops on one thread (the suite's workers share few cores)."""
    return (f"--xla_force_host_platform_device_count={devices} "
            "--xla_backend_optimization_level=0 "
            "--xla_llvm_disable_expensive_passes=true "
            "--xla_cpu_multi_thread_eigen=false")
