"""The JAX package's ten examples (``examples/*.py``) on the port's names.
Each module's ``main()`` keeps the JAX example's arguments and takes
``device`` (default ``"cuda"``, with no CPU fallback); run one with

    python -m tinympc_julia_tpu_torch.examples.cartpole_mpc
"""
