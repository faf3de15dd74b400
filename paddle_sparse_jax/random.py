"""Library-level PRNG state for the eager facade.

JAX randomness is functional (explicit keys).  The reference API draws from
global framework state (``paddle.rand`` in ``sample.py:23``), so the eager
facade keeps a module-level key that callers can seed; every keyless call
splits off a fresh subkey.  Jittable kernels in ``ops/`` always take explicit
keys.
"""
import jax

# the key is made on first use: importing the package must not start a
# device backend (a process that only plans or checks must not reserve
# the card's memory)
_state = {"seed": 0, "key": None}


def seed(n: int) -> None:
    """Seed the facade's global PRNG stream."""
    _state["seed"], _state["key"] = n, None


def next_key() -> jax.Array:
    key = _state["key"]
    if key is None:
        key = jax.random.PRNGKey(_state["seed"])
    _state["key"], sub = jax.random.split(key)
    return sub
