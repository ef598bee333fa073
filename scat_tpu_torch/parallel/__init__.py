"""Scale-out (port of ``scat_tpu/parallel``): the ``--mesh_shape`` axes
``data``, ``model``, ``seq`` and ``pipe`` over ``torch.distributed``
process groups, one process per device (``mesh``), the Megatron and
sequence-parallel rules (``sharding_rules``) and the GPipe schedule over
homogeneous blocks (``pipeline``)."""
