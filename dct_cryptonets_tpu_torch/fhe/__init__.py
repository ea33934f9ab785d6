"""TFHE runtime, circuit simulator and compiler (PyTorch port).

Client-side randomness, LWE encrypt/decrypt and the noise model are numpy
code, the port's own copies (``fhe.keys``, ``fhe.params``) of the JAX
package's; they are re-exported here."""
from .keys import Csprng, decrypt_lwe, encrypt_lwe
from .params import NoiseModel

__all__ = ["Csprng", "NoiseModel", "decrypt_lwe", "encrypt_lwe"]
