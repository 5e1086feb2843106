SELECT dt2.Term, SUM(dt2.Fre)
FROM DT dt2
WHERE dt2.Doc IN
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t1)
  INTERSECT
  (SELECT dt.Doc FROM DT dt WHERE dt.Term = :t2)
GROUP BY dt2.Term
