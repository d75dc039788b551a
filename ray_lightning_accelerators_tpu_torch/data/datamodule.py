"""DataModule: bundles the train / val / test / predict loaders.

Port of the JAX package's ``data/datamodule.py`` (a LightningDataModule
analog).  ``Trainer.fit`` / ``validate`` / ``test`` / ``predict`` take one
as ``datamodule=``, call ``setup(stage)`` with "fit", "validate", "test"
or "predict", and use its loaders where the caller passed none.
"""

from __future__ import annotations

from typing import Optional

from .loader import DataLoader


class DataModule:
    def setup(self, stage: str) -> None:
        pass

    def train_dataloader(self) -> Optional[DataLoader]:
        return None

    def val_dataloader(self) -> Optional[DataLoader]:
        return None

    def test_dataloader(self) -> Optional[DataLoader]:
        return None

    def predict_dataloader(self) -> Optional[DataLoader]:
        return self.test_dataloader()
