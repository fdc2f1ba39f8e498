"""Host-side helpers: pytree utilities and JAX-state interop."""
