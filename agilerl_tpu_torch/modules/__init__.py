"""Functional layers (``layers``, ``custom_components``) and the evolvable
modules of the classic RL stack: ``base``, ``mlp``, ``cnn``, ``resnet``,
``simba``, ``lstm``, ``multi_input``, ``dummy`` and the net ``configs``."""
