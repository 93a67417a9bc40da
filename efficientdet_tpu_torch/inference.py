"""Alias of :mod:`efficientdet_tpu_torch.predict` under the reference's script name."""

from efficientdet_tpu_torch.predict import Predictor, main  # noqa: F401

if __name__ == "__main__":
    main()
