"""Launch layer: the train steps and the resilient train loop, on one
device or a data-parallel mesh (:mod:`.train`), the meshes and their
sharding rules (:mod:`.mesh`, :mod:`.sharding`), and the ``train_lm``
entry point (:mod:`.train_lm`)."""
