"""Shared inputs and fixtures of the torch-port tests (tests/test_torch_*).

Inputs are made with numpy from fixed seeds and handed to both the JAX
package (on the CPU, its Pallas kernels in interpret mode) and the port.
"""

import numpy as np
import pytest
import torch

REC = b'{"id":%d,"name":"user","tags":["a","b"],"ok":true}\n'


@pytest.fixture
def cuda():
    """The GPU, or a skip where torch sees none (decided per test, never at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.fixture
def one_torch_thread():
    """Torch's CPU ops on one thread for the test. The port's XLA engine
    runs long int64 torch ops; with six test workers, each op's OpenMP
    pool on every core made the workers' ops wait on one another (tests
    ran 100x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_payload(n: int, seed: int) -> np.ndarray:
    """JSON-like records, a low-entropy stretch, and random bytes: sparse,
    dense and stored 64 KB blocks in one payload."""
    rng = np.random.default_rng(seed)
    parts = [np.frombuffer(b"".join(REC % (i * 7919 % 1000)
                                    for i in range(n // 2 // 50 + 1)),
                           np.uint8)[: n // 2],
             rng.integers(0, 16, n // 4).astype(np.uint8),
             rng.integers(0, 256, n - n // 2 - n // 4).astype(np.uint8)]
    return np.concatenate(parts)
