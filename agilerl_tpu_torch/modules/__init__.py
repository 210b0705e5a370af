"""Functional layers (``layers``) and the evolvable modules of the classic
RL stack (``base``, ``mlp``, ``configs``); the CNN, LSTM, multi-input, SimBa
and ResNet modules come with slice 5b."""
