"""Retriever factory ABCs (reference stdlib/indexing/retrievers.py).

A retriever factory builds a :class:`DataIndex` over a table of
documents; DocumentStore and VectorStoreServer are parameterized by one.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ...internals.table import Table
    from .data_index import DataIndex, InnerIndex


class AbstractRetrieverFactory(ABC):
    @abstractmethod
    def build_index(
        self,
        data_column,
        data_table: "Table",
        metadata_column=None,
    ) -> "DataIndex":
        ...


class InnerIndexFactory(AbstractRetrieverFactory):
    @abstractmethod
    def build_inner_index(self, data_column, metadata_column=None) -> "InnerIndex":
        ...

    def build_index(self, data_column, data_table, metadata_column=None) -> "DataIndex":
        from .data_index import DataIndex

        inner = self.build_inner_index(data_column, metadata_column)
        return DataIndex(data_table=data_table, inner_index=inner)
